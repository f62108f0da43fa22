"""The traced stretch of a ``--trace 1`` run and its reduction.

A ``Stretch`` runs the Kineto profiler (CPU and CUDA activities) around a
short steady part of the window that the window driver chooses: it synchronises
the device before it starts and before it stops, so the stretch's wall
(``window_s``) holds all of its device work. On the host it records only
the user scope (the ``record_function`` ranges), not every operator:
recording the operators of a decode step's ~1160 launches made a traced
step take 53 ms against ~24 ms untraced on an H100 host at 700 W, which
would have read as idle device time. CUPTI still records every runtime
call and every kernel. CUPTI now and then returns a trace without a
kernel (seen twice on the H100, 2a03127): such a take is dropped and the
window driver arms the stretch again on later work, up to ``TRIES``
takes, as ``chip_smoke.py::kernel_device_ms`` retakes an empty trace
(frozen from 2a03127).

``reduce_trace`` works on the exported Chrome trace alone:

* busy seconds: the union of the device's kernel, copy and set intervals
  (overlapping streams are counted once);
* launch calls: host runtime calls whose name starts with ``cudaLaunch``
  or ``cuLaunch`` (what ``tools/profile_label.py`` counts), and graph
  launches (``cudaGraphLaunch``, ``cuGraphLaunch``): a replayed CUDA graph
  is one launch call, however many kernels it holds;
* ranges: ``record_function`` ranges named ``bench:<name>`` that the
  benchmark's own files open around calls into the port; a kernel belongs
  to a range when the runtime call that launched it (matched by CUPTI's
  correlation id) lies inside one of the range's instances on the same
  host thread. Every kernel of a replayed graph carries the correlation
  id of its graph launch, so it belongs to the ranges open at that
  launch;
* per step: launch calls between the starts of consecutive
  ``bench:step`` ranges;
* the breakdown: the device operations that took most time, and the
  longest idle gaps named by the innermost host range or runtime call
  running when each began.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

TRIES = 3
STEP_RANGE = "bench:step"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Stretch:
    """One traced stretch at a time. ``result`` holds the reduction of the
    first take that traced a kernel, with ``acc``: the sums that the
    metrics' wrappers add up (bounds from shapes) while the take runs."""

    def __init__(self, name: str, workdir: str, device: torch.device):
        self.name = name
        self.workdir = workdir
        self.device = device
        self.prof = None
        self.t0 = 0.0
        self.tries = 0
        self.result: Optional[dict] = None
        self.acc: Dict[str, float] = defaultdict(float)  # per take, from wrappers

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def wanted(self) -> bool:
        return self.result is None and self.tries < TRIES and self.prof is None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import _enable_profiler, _prepare_profiler

        self._sync()
        self.acc = defaultdict(float)
        cuda = self.device.type == "cuda"
        prof = torch.autograd.profiler.profile(use_kineto=True,
                                               use_device="cuda" if cuda else None)
        cfg = prof.config()
        _prepare_profiler(cfg, prof.kineto_activities)
        _enable_profiler(cfg, prof.kineto_activities, {RecordScope.USER_SCOPE})
        self.prof = prof
        self.t0 = time.perf_counter()

    def stop(self):
        from torch.autograd import _disable_profiler

        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof = None
        result = _disable_profiler()
        self.tries += 1
        path = os.path.join(self.workdir, f"trace_{self.name}_{self.tries}.json")
        result.save(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        red = reduce_trace(events, wall)
        red["acc"] = dict(self.acc)
        if red["kernels"] > 0 or self.device.type != "cuda":
            self.result = red


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce_trace(events: List[dict], window_s: float) -> dict:
    """The stretch's numbers from its Chrome trace events (times in us)."""
    device, host, launches, ranges = [], [], [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur, name, (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append((ts, ts + dur, name, e.get("tid")))
            if name.startswith(_LAUNCHES):
                launches.append((ts, e.get("tid"), (e.get("args") or {}).get("correlation")))
        elif cat in _HOST_CATS:
            host.append((ts, ts + dur, name, e.get("tid")))
            if cat == "user_annotation" and name.startswith("bench:"):
                ranges[name].append((ts, ts + dur, e.get("tid")))

    busy = _union([(a, b) for a, b, _, _ in device])
    busy_us = sum(b - a for a, b in busy)

    by_corr = {c: (ts, tid) for ts, tid, c in launches if c is not None}
    range_device = {}
    for rname, inst in ranges.items():
        inst = sorted(inst)
        starts = [a for a, _, _ in inst]
        total = 0.0
        n = 0
        for a, b, _, corr in device:
            hit = by_corr.get(corr)
            if hit is None:
                continue
            ts, tid = hit
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and inst[i][1] >= ts and inst[i][2] == tid:
                total += b - a
                n += 1
        range_device[rname[len("bench:"):]] = {"device_s": total / 1e6, "kernels": n,
                                              "calls": len(inst)}

    step_starts = sorted(a for a, _, _ in ranges.get(STEP_RANGE, []))
    per_step = []
    if len(step_starts) >= 2:
        lt = sorted(ts for ts, _, _ in launches)
        for s0, s1 in zip(step_starts, step_starts[1:]):
            per_step.append(bisect.bisect_left(lt, s1) - bisect.bisect_left(lt, s0))

    ops = defaultdict(float)
    for a, b, name, _ in device:
        ops[name] += (b - a) / 1e6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]

    gaps = []
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        gaps.append((a1 - b0, b0))
    gaps.sort(reverse=True)
    host.sort()
    hstarts = [h[0] for h in host]
    idle = []
    for g, at in gaps[:10]:
        i = bisect.bisect_right(hstarts, at)
        inner = None
        for h in host[max(0, i - 2000):i]:
            if h[1] >= at and (inner is None or h[1] - h[0] < inner[1] - inner[0]):
                inner = h
        idle.append([inner[2] if inner else "(no host op)", g / 1e6])

    return {"window_s": window_s, "busy_s": busy_us / 1e6, "kernels": len(device),
            "launches": len(launches), "launches_per_step": per_step,
            "ranges": range_device, "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": idle}


def launches_per_step(traces: Optional[dict], skip: int = 2) -> Optional[float]:
    """Mean launch calls per step over the steady steps (the first ``skip``
    of a stretch left out) of every stretch that marked steps."""
    steps = [n for red in (traces or {}).values() if red
             for n in red["launches_per_step"][skip:]]
    return sum(steps) / len(steps) if steps else None


def range_roofline(traces: Optional[dict], name: str) -> Optional[float]:
    """Percent of its bound that the device time of the kernels launched in
    ``bench:<name>`` ranges reached: the bound (``acc[name]``, seconds, from
    shapes) over that device time, summed over every stretch that has the
    range. None where no stretch has it."""
    bound = device = 0.0
    for red in (traces or {}).values():
        if red and name in red["ranges"] and red["ranges"][name]["kernels"]:
            bound += red["acc"].get(name, 0.0)
            device += red["ranges"][name]["device_s"]
    return 100.0 * bound / device if device > 0 and bound > 0 else None


def idle_share(red: Optional[dict]) -> Optional[float]:
    if not red or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def breakdown(red: Optional[dict]) -> Optional[Dict[str, list]]:
    if not red:
        return None
    return {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
