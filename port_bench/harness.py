"""Finding a cell's files by name, the run's context, and the result line.

``plan`` reads ``BENCHMARK.json`` and resolves a cell to its configuration
file, its traffic file, the driver that the traffic names and the per-layer
metrics that the cell reports, each by path under the checkout. A later
change adds a configuration, a mix, a driver or a metric by adding a file
and an entry: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import sys
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

BANNED_MODULES = ("jax", "jaxlib", "flax", "taiwan_whisper_tpu")


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``: it passes when ``value`` is at
    most ``limit``. ``items`` counts the answers it failed."""

    name: str
    value: float
    limit: float
    items: int = 0
    detail: Optional[dict] = None  # what the number was read from, for the readings

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Plan:
    root: str
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    driver_path: str
    end_to_end: List[dict]
    per_layer: List[dict]
    metric_paths: Dict[str, str]

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def read_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return json.load(f)


def bench_dir(bench: dict) -> str:
    """The folder under ``paths`` that holds this harness."""
    return bench["paths"][0]


def metric_file(bench: dict, name: str) -> str:
    return os.path.join(bench_dir(bench), "metrics", f"{name}.py")


def cells_reporting(bench: dict, metric: dict) -> List[str]:
    """The cells that report a metric: its ``workloads``, or every cell
    that reports what it moves (an end-to-end metric: every cell its own
    ``workloads`` names, or all)."""
    if "workloads" in metric:
        return list(metric["workloads"])
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return cells_reporting(bench, moved)
    return [w["name"] for w in bench["workloads"]]


def plan(root: str, workload: str, bench: Optional[dict] = None) -> Plan:
    bench = bench or load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = read_json(root, config_entry["file"])
    traffic = read_json(root, os.path.join(bench_dir(bench), "traffic",
                                            f"{cell['traffic']}.json"))
    driver = os.path.join(root, bench_dir(bench), "drivers", f"{traffic['driver']}.py")
    e2e = [m for m in bench["end_to_end"] if workload in cells_reporting(bench, m)]
    layer = [m for m in bench["per_layer"] if workload in cells_reporting(bench, m)]
    return Plan(root=root, bench=bench, cell=cell, config=config, traffic=traffic,
                driver_path=driver, end_to_end=e2e, per_layer=layer,
                metric_paths={m["name"]: os.path.join(root, metric_file(bench, m["name"]))
                              for m in layer})


def load_file(path: str, modname: str):
    """Import a file by path (metric files have dots in their names)."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(p: Plan):
    return load_file(p.driver_path, "port_bench_driver_" + p.traffic["driver"])


def load_metrics(p: Plan) -> Dict[str, Any]:
    return {name: load_file(path, "port_bench_metric_" + name.replace(".", "_").replace("-", "_"))
            for name, path in p.metric_paths.items()}


def derive_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run, from ``--seed``."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, stream: str) -> np.random.RandomState:
    """numpy's legacy generator (what the frozen audio generators draw
    from), seeded from any whole number."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence(
        derive_seed(seed, stream))))


class Ctx:
    """What a driver gets: the plan, the run's arguments, the device, a
    work directory (removed after the run), the traced stretch, the CUDA
    graphs recorded while a run traces (``graphs``, a ``trace.Graphs``
    once ``trace.watch_graphs`` made it), and ``patch`` for wrapping an
    attribute of the port for the run's life.
    ``batches``, where given, cuts a window of fixed work to that many
    batches (the readings of ``readings.py``)."""

    def __init__(self, plan_: Plan, *, seed: int, seconds: float, trace: bool, device,
                 workdir: str, batches: Optional[int] = None):
        self.plan = plan_
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workdir = workdir
        self.batches = batches
        self.stretches: Dict[str, Stretch] = {}
        self.graphs = None
        self._patches: List[tuple] = []

    @property
    def config(self) -> dict:
        return self.plan.config

    @property
    def traffic(self) -> dict:
        return self.plan.traffic

    def stretch(self, name: str):
        """The traced stretch ``name`` (made on first use)."""
        from .trace import Stretch

        if name not in self.stretches:
            self.stretches[name] = Stretch(name, self.workdir, self.device, self.graphs)
        return self.stretches[name]

    def active_stretch(self):
        """What a range wrapper adds its bound to (``acc``) now: the CUDA
        graph capture being recorded (its work runs at its replays), else
        the stretch being traced, else None."""
        return self.capturing() or next((s for s in self.stretches.values() if s.active), None)

    def capturing(self):
        """The CUDA graph capture being recorded now, or None."""
        return self.graphs.capturing if self.graphs is not None else None

    def traces(self) -> Dict[str, Optional[dict]]:
        return {name: s.result for name, s in self.stretches.items()}

    def rng(self, stream: str) -> np.random.RandomState:
        return rng(self.seed, stream)

    def torch_seed(self, stream: str) -> int:
        return derive_seed(self.seed, stream)

    def patch(self, obj, attr: str, make: Callable[[Any], Any]):
        """Replace ``obj.attr`` by ``make(old)`` until ``unpatch``."""
        old = getattr(obj, attr)
        self._patches.append((obj, attr, old))
        setattr(obj, attr, make(old))

    def unpatch(self):
        while self._patches:
            obj, attr, old = self._patches.pop()
            setattr(obj, attr, old)


_CORES = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []


def steady_process():
    """Before set-up, on the card: one intra-op thread for the port's host
    tensors, so that no idle OpenMP team spins beside the thread that
    launches the kernels."""
    import torch

    torch.set_num_threads(1)


def settle(device):
    """At the window's start, on the card: what set-up left is frozen out
    of the collector's way, and the calling (launching) thread runs on a
    core of its own (the last it may use), every other thread of the
    process on the rest. Called again as the window goes on, it also
    moves threads that the port started since (they inherit the launching
    thread's core)."""
    if getattr(device, "type", device) != "cuda":
        return
    gc.collect()
    gc.freeze()
    pin_launcher()


def pin_launcher():
    if len(_CORES) < 2:
        return
    own, rest = {_CORES[-1]}, set(_CORES[:-1])
    me = threading.get_native_id()
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), own if int(tid) == me else rest)
        except OSError:  # a thread that ended meanwhile
            pass


def banned_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``taiwan_whisper_tpu_torch`` is not
    ``taiwan_whisper_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED_MODULES)


def result_line(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: List[Check], breakdown: Optional[dict]) -> str:
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": _finite(c.value), "limit": _finite(c.limit)}
                     for c in checks}
    return json.dumps(out)


def _finite(x: float) -> float:
    x = float(x)
    if x != x:
        return 1e300
    return max(min(x, 1e300), -1e300)
