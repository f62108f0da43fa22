"""Profiling and tracing hooks (port of taiwan_whisper_tpu/utils/profiling.py).

* `trace(dir)` — context manager around torch.profiler (CPU activity, and
  CUDA when a card is present) that writes a Chrome trace JSON into ``dir``,
  viewable in Perfetto or chrome://tracing;
* `StepTimer` — cheap rolling wall-clock stats for train/decode loops;
* `device_time(fn, *args)` — seconds per call, each call waited for by
  synchronising the device of the output's first tensor (nothing to wait
  for on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import deque
from typing import Callable, Deque, Optional

import numpy as np
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


class StepTimer:
    """Rolling throughput stats: call tick() once per step."""

    def __init__(self, window: int = 50):
        self._times: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def mean_step_seconds(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    @property
    def steps_per_second(self) -> float:
        m = self.mean_step_seconds
        return 1.0 / m if m > 0 else 0.0


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
