"""The two reductions of a traced stretch as they were before a replayed
CUDA graph's operations were credited to the ranges they were captured in
(``port_bench/trace.py::reduce_trace`` and ``port_bench/spans.py::
reduce_spans`` at commit 9dde994), frozen: a trace with no replay of a
recorded capture must reduce to the same fields under the new rule
(``test_port_bench_trace.py``)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
STEP_RANGE = "bench:step"
PREFIX = "tw:"


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


def reduce_spans(events: List[dict]) -> Dict[str, dict]:
    """``{name: {"calls": instances, "device_s": device seconds credited,
    "ops": device operations credited}}`` of every ``tw:`` range in the
    Chrome trace events (times in us)."""
    ranges: Dict[str, Dict[object, list]] = defaultdict(lambda: defaultdict(list))
    launched = {}  # correlation id -> (start of the runtime call, its thread)
    device = []  # (duration, correlation id)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges[name[len(PREFIX):]][e.get("tid")].append((ts, ts + dur))
        elif cat in _RUNTIME_CATS and corr is not None:
            launched[corr] = (ts, e.get("tid"))
        elif cat in _DEVICE_CATS and corr is not None:
            device.append((dur, corr))

    out = {}
    for name, by_tid in ranges.items():
        held = {tid: _union(iv) for tid, iv in by_tid.items()}  # nested instances merged
        starts = {tid: [a for a, _ in iv] for tid, iv in held.items()}
        total = 0.0
        n = 0
        for dur, corr in device:
            hit = launched.get(corr)
            if hit is None or hit[1] not in held:
                continue
            ts, tid = hit
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and held[tid][i][1] >= ts:
                total += dur
                n += 1
        out[name] = {"calls": sum(len(iv) for iv in by_tid.values()),
                     "device_s": total / 1e6, "ops": n}
    return out

