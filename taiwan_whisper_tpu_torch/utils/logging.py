"""Metrics sinks: stdout and a JSONL file (port of
taiwan_whisper_tpu/utils/logging.py). The JSONL file is the system of
record; wandb waits for a later slice of the port (ROADMAP Queue A 6)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: Optional[str] = None, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError(
                "--wandb waits for a later slice of the port (ROADMAP Queue A 6)")
        self._jsonl = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a",
                               encoding="utf-8")

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

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
