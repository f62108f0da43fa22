"""Hyper-parameter sweeps over wandb-style sweep YAMLs (port of
taiwan_whisper_tpu/pipeline/sweep.py).

The reference records its HP searches as wandb sweep configs
(training/flax/distillation_scripts/run_bs_sweep.yaml, run_lr_sweep.yaml,
run_mse_sweep.yaml, ...) and relies on a hosted wandb agent to expand and
schedule them. This module reads the same YAML schema (method:
grid|random, metric: {name, goal}, parameters: {value | values |
min/max[+distribution]}) and runs the expansion locally against the port's
own CLI, each run on the device its ``--device`` names (cuda unless given).
Results land in ``<out_dir>/sweep_results.jsonl`` plus a ``best.json``
summary. PyYAML and wandb are imported where they are used.

YAML mapping:
  * ``program``/``command`` — ignored except for a trailing subcommand name;
    the subcommand to run is given explicitly (``--target distill``).
  * ``parameters.<name>.value``        — fixed for every run
  * ``parameters.<name>.values: [..]`` — grid axis (or random choice)
  * ``parameters.<name>.{min,max}``    — random methods only; uniform or
    log_uniform_values like wandb
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import random
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class SweepSpec:
    method: str  # "grid" | "random"
    metric_name: Optional[str]
    metric_goal: str  # "minimize" | "maximize"
    fixed: Dict[str, Any]
    axes: Dict[str, List[Any]]  # discrete axes (values:)
    ranges: Dict[str, Dict[str, Any]]  # continuous axes (min/max)


def load_sweep(path: str) -> SweepSpec:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    method = str(doc.get("method", "grid")).lower()
    metric = doc.get("metric") or {}
    fixed: Dict[str, Any] = {}
    axes: Dict[str, List[Any]] = {}
    ranges: Dict[str, Dict[str, Any]] = {}
    for name, spec in (doc.get("parameters") or {}).items():
        if not isinstance(spec, dict):
            fixed[name] = spec
        elif "value" in spec:
            fixed[name] = spec["value"]
        elif "values" in spec:
            axes[name] = list(spec["values"])
        elif "min" in spec and "max" in spec:
            ranges[name] = dict(spec)
        else:
            raise ValueError(f"unsupported parameter spec for {name}: {spec}")
    if method == "grid" and ranges:
        raise ValueError("min/max parameters require method: random")
    return SweepSpec(
        method=method,
        metric_name=metric.get("name"),
        metric_goal=str(metric.get("goal", "minimize")),
        fixed=fixed,
        axes=axes,
        ranges=ranges,
    )


def expand_configs(
    spec: SweepSpec, max_runs: int = 0, seed: int = 0
) -> List[Dict[str, Any]]:
    """All run configs for a grid sweep; sampled configs for a random sweep."""
    if spec.method == "grid":
        names = sorted(spec.axes)
        combos = itertools.product(*(spec.axes[n] for n in names))
        configs = [dict(spec.fixed, **dict(zip(names, c))) for c in combos]
        if max_runs:
            configs = configs[:max_runs]
        return configs
    if spec.method != "random":
        raise ValueError(f"unsupported sweep method: {spec.method}")
    rng = random.Random(seed)
    n = max_runs or 10
    configs = []
    for _ in range(n):
        cfg = dict(spec.fixed)
        for name, vals in spec.axes.items():
            cfg[name] = rng.choice(vals)
        for name, r in spec.ranges.items():
            lo, hi = float(r["min"]), float(r["max"])
            dist = str(r.get("distribution", "uniform"))
            if "log" in dist:
                val = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                val = rng.uniform(lo, hi)
            if r.get("distribution") in ("int_uniform", "q_uniform"):
                val = int(round(val))
            cfg[name] = val
        configs.append(cfg)
    return configs


def _to_argv(target: str, cfg: Dict[str, Any], extra: Sequence[str]) -> List[str]:
    argv = [target]
    for k, v in cfg.items():
        if isinstance(v, bool):
            if v:
                argv.append(f"--{k}")
        else:
            argv.extend([f"--{k}", str(v)])
    argv.extend(extra)
    return argv


def _lookup_metric(result: Any, name: Optional[str]) -> Optional[float]:
    if not isinstance(result, dict) or not result:
        return None
    if name:
        if name in result:
            return float(result[name])
        # wandb-style "train/loss" -> our flat "loss"
        tail = name.split("/")[-1]
        if tail in result:
            return float(result[tail])
    for key in ("loss", "mer", "wer"):
        if key in result:
            return float(result[key])
    return None


def run_sweep(
    yaml_path: str,
    target: str,
    out_dir: str,
    extra_argv: Sequence[str] = (),
    max_runs: int = 0,
    seed: int = 0,
    runner: Optional[Callable[[List[str]], Any]] = None,
) -> Dict[str, Any]:
    """Expand the sweep and run every config through the CLI.

    ``runner`` takes a full CLI argv and returns that run's metrics dict
    (defaults to the port's :func:`taiwan_whisper_tpu_torch.cli.main`).
    Per-run output dirs are ``<out_dir>/run_<i>``; a failing run is
    recorded and skipped.
    """
    if runner is None:
        from ..cli import main as runner  # type: ignore[assignment]

    spec = load_sweep(yaml_path)
    configs = expand_configs(spec, max_runs=max_runs, seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    results_path = os.path.join(out_dir, "sweep_results.jsonl")
    best: Optional[Dict[str, Any]] = None
    sign = -1.0 if spec.metric_goal == "maximize" else 1.0
    with open(results_path, "w") as f:
        for i, cfg in enumerate(configs):
            run_cfg = dict(cfg)
            run_cfg.setdefault("output_dir", os.path.join(out_dir, f"run_{i}"))
            argv = _to_argv(target, run_cfg, extra_argv)
            record: Dict[str, Any] = {"run": i, "params": run_cfg}
            try:
                result = runner(argv)
                record["result"] = result
                metric = _lookup_metric(result, spec.metric_name)
                if metric is not None:
                    record["metric"] = metric
                    if best is None or sign * metric < sign * best["metric"]:
                        best = record
            except Exception as e:  # noqa: BLE001 — record, continue sweep
                record["error"] = f"{type(e).__name__}: {e}"
            f.write(json.dumps(record) + "\n")
            f.flush()
    summary = {
        "n_runs": len(configs),
        "metric": spec.metric_name,
        "goal": spec.metric_goal,
        "best": best,
        "results": results_path,
    }
    with open(os.path.join(out_dir, "best.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def run_sweep_agent(
    yaml_path: Optional[str],
    target: str,
    out_dir: str,
    extra_argv: Sequence[str] = (),
    *,
    sweep_id: Optional[str] = None,
    project: Optional[str] = None,
    entity: Optional[str] = None,
    count: Optional[int] = None,
    runner: Optional[Callable[[List[str]], Any]] = None,
) -> Dict[str, Any]:
    """Join (or create) a HOSTED wandb sweep as an agent — the reference's
    actual HP-search mode (flax/distillation_scripts/run_bs_sweep.yaml is
    consumed by ``wandb sweep`` + ``wandb agent``). Each agent iteration
    receives a config from the wandb scheduler, runs it through the CLI,
    and logs the target metric back, so Bayesian/random scheduling and
    early termination work exactly as upstream. Requires the ``wandb``
    package and network access; :func:`run_sweep` is the offline local
    expansion of the same YAMLs.

    ``sweep_id`` joins an existing sweep; otherwise the YAML is registered
    as a new sweep first. Joined without a YAML, the agent knows no metric
    name and logs the run's numeric results under their own keys only, as
    the JAX package does. Returns {sweep_id, runs} (run count this agent
    completed)."""
    try:
        import wandb
    except ImportError as e:  # pragma: no cover - exercised via stub
        raise RuntimeError(
            "sweep --agent requires the wandb package; use the local "
            "expansion mode (cli sweep without --agent) offline"
        ) from e
    if runner is None:
        from ..cli import main as runner  # type: ignore[assignment]

    metric_name = None
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            doc = yaml.safe_load(f)
        metric_name = (doc.get("metric") or {}).get("name")
        if sweep_id is None:
            sweep_id = wandb.sweep(doc, project=project, entity=entity)
    if sweep_id is None:
        raise ValueError("need --config or --sweep_id")
    os.makedirs(out_dir, exist_ok=True)
    done = {"runs": 0}

    def one_run():
        run = wandb.init()
        try:
            cfg = dict(run.config)
            cfg.setdefault(
                "output_dir",
                os.path.join(out_dir, f"run_{run.id}"),
            )
            argv = _to_argv(target, cfg, extra_argv)
            result = runner(argv)
            metric = _lookup_metric(result, metric_name)
            payload = result if isinstance(result, dict) else {}
            if metric is not None and metric_name:
                payload = dict(payload)
                payload[metric_name] = metric
            if payload:
                run.log({k: v for k, v in payload.items()
                         if isinstance(v, (int, float))})
            done["runs"] += 1
        finally:
            run.finish()

    wandb.agent(sweep_id, function=one_run, count=count,
                project=project, entity=entity)
    return {"sweep_id": sweep_id, "runs": done["runs"]}
