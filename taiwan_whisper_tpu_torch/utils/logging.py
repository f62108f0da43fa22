"""Metrics sinks: stdout, a JSONL file and, optionally, wandb (port of
taiwan_whisper_tpu/utils/logging.py). The JSONL file is the system of
record. In a multi-process run rank 0 alone owns the file and the wandb
run; the other ranks print."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from ..parallel import mesh


class MetricsLogger:
    def __init__(self, output_dir: Optional[str] = None, use_wandb: bool = False):
        is_main = mesh.is_main()
        self._jsonl = None
        if output_dir and is_main:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a",
                               encoding="utf-8")
        self._wandb = None
        if use_wandb and is_main:
            try:  # wandb is optional: without it the run goes on, logged here
                import wandb

                self._wandb = wandb
                wandb.init(project="taiwan-whisper-tpu")
            except Exception as e:
                self._wandb = None
                print(f"[metrics] wandb unavailable ({e}); continuing without")

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "train"):
        payload = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        payload["step"] = step
        payload["time"] = time.time()
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in payload.items() if k != "time")
        print(f"[{prefix}] {line}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(payload, step=step)

    def log_table(self, name: str, columns, rows, step: int, prefix: str = "eval"):
        """A per-sample table (the generation eval's predictions): one JSONL
        record ``{"table", "columns", "rows", "step", "time"}``, and a
        ``wandb.Table`` when wandb is on."""
        payload = {"table": f"{prefix}/{name}", "columns": list(columns),
                   "rows": [list(r) for r in rows], "step": step, "time": time.time()}
        print(f"[{prefix}] table {name}: {len(rows)} rows", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(payload, ensure_ascii=False) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log({f"{prefix}/{name}": self._wandb.Table(
                columns=list(columns), data=[list(r) for r in rows])}, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None
