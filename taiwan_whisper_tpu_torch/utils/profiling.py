"""Profiling and tracing hooks (port of taiwan_whisper_tpu/utils/profiling.py).

* `trace(dir)` — context manager around torch.profiler (CPU activity, and
  CUDA when a card is present) that writes a Chrome trace JSON into ``dir``,
  viewable in Perfetto or chrome://tracing;
* `device_time(fn, *args)` — seconds per call, each call waited for by
  synchronising the device of the output's first tensor (nothing to wait
  for on the CPU);
* `span(name)` and `count(name, n)` — the port's own spans and counters,
  placed at the layer boundaries of the label and train paths. A span adds
  one call and its host seconds (``perf_counter``) to process-wide totals
  under ``name``, and to ``into[key]`` when given. While a profiler
  records (``trace`` here, or any torch.profiler / Kineto session), it
  also opens ``record_function("tw:" + name)``, so the range lies in the
  Chrome trace on the clock of the device's kernels and runtime calls;
  with no profiler it opens none (entering one costs ~10 us on a CPU host,
  a span under 1 us). `snapshot()` and `since(snap)` read the totals and
  their change over an interval, summed over every thread of the process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace into ``log_dir`` when it is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor of a (nested) tuple, list, dict or dataclass."""
    if isinstance(out, torch.Tensor):
        return out
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def device_time(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Average seconds per call of ``fn(*args)``, each call synchronised on
    its output's CUDA device."""

    def sync(out):
        leaf = _first_tensor(out)
        if leaf is not None and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)

    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        sync(fn(*args))
    return (time.perf_counter() - t0) / iters



# each thread adds to tables of its own (no lock on the way; no update is
# lost), registered once; a snapshot sums every thread's
_local = threading.local()
_tables: List[Tuple[dict, dict]] = []  # (spans {name: [calls, seconds]}, counts)
_register_lock = threading.Lock()
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


def _register() -> Tuple[dict, dict]:
    tables = _local.spans, _local.counts = {}, {}
    with _register_lock:
        _tables.append(tables)
    return tables


class span:
    """``with span(name, into=None, key=None):`` times its body on the host
    (see the module docstring). ``into[key]`` (a number already there)
    gets the same seconds."""

    __slots__ = ("name", "into", "key", "t0", "rf")

    def __init__(self, name: str, into: Optional[dict] = None, key: Optional[str] = None):
        self.name = name
        self.into = into
        self.key = key

    def __enter__(self):
        if _profiling():
            rf = self.rf = torch.profiler.record_function("tw:" + self.name)
            rf.__enter__()
        else:
            self.rf = None
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self.t0
        try:
            spans = _local.spans
        except AttributeError:
            spans = _register()[0]
        rec = spans.get(self.name)
        if rec is None:
            spans[self.name] = [1, dt]
        else:
            rec[0] += 1
            rec[1] += dt
        if self.into is not None:
            self.into[self.key] += dt
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


def count(name: str, n: int):
    """Add ``n`` to the counter ``name``."""
    try:
        counts = _local.counts
    except AttributeError:
        counts = _register()[1]
    counts[name] = counts.get(name, 0) + n


def snapshot() -> dict:
    """The totals now, over every thread: ``{"spans": {name: (calls,
    seconds)}, "counts": {name: n}}``."""
    with _register_lock:
        tables = list(_tables)
    spans: Dict[str, Tuple[int, float]] = {}
    counts: Dict[str, int] = {}
    for sp, ct in tables:
        for k, (calls, secs) in list(sp.items()):
            c0, s0 = spans.get(k, (0, 0.0))
            spans[k] = (c0 + calls, s0 + secs)
        for k, n in list(ct.items()):
            counts[k] = counts.get(k, 0) + n
    return {"spans": spans, "counts": counts}


def since(snap: dict) -> dict:
    """What changed after ``snap``: ``{"spans": {name: {"calls",
    "seconds"}}, "counts": {name: n}}``, each name that moved (plain dicts:
    they print as JSON)."""
    now = snapshot()
    spans = {}
    for k, (calls, secs) in now["spans"].items():
        c0, s0 = snap["spans"].get(k, (0, 0.0))
        if calls != c0:
            spans[k] = {"calls": calls - c0, "seconds": secs - s0}
    counts = {k: n - snap["counts"].get(k, 0) for k, n in now["counts"].items()
              if n != snap["counts"].get(k, 0)}
    return {"spans": spans, "counts": counts}
