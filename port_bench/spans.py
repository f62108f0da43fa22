"""The port's own ``tw:`` ranges in a traced stretch.

While a profiler records, each span of ``taiwan_whisper_tpu_torch/utils/
profiling.py`` opens ``record_function("tw:<name>")``. ``reduce_spans``
credits device time to those ranges by the rule of ``trace.py``: a device
operation (kernel, copy or set) belongs to a range when the runtime call
that launched it, matched by CUPTI's correlation id, lies inside one of the
range's instances on the same host thread. Every kernel of a replayed CUDA
graph carries the correlation id of its graph launch, so it belongs to the
ranges open at that launch. Ranges nest: a kernel launched inside
``tw:decode.step`` inside ``tw:decode.loop`` counts in both.

``install(ctx)``, called by the metric files that read ranges, wraps
``trace.reduce_trace`` for the run, so that each stretch's reduction also
holds ``spans``: ``{name: {"calls", "device_s", "ops"}}``. A program
without the spans (an older commit of the port) leaves it empty, and the
metrics read nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

PREFIX = "tw:"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


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


def _with_spans(orig):
    def reduce_trace(events, window_s):
        red = orig(events, window_s)
        red["spans"] = reduce_spans(events)
        return red

    reduce_trace.with_spans = True
    return reduce_trace


def install(ctx):
    """Wrap ``trace.reduce_trace`` for the run (once, however many metric
    files ask)."""
    from port_bench import trace

    if not getattr(trace.reduce_trace, "with_spans", False):
        ctx.patch(trace, "reduce_trace", _with_spans)


def device_share(traces: Optional[dict], stretch: str, name: str) -> Optional[float]:
    """Percent of the stretch's busy device time that operations launched
    inside ``tw:<name>`` took; None where the stretch holds no such
    operation (no range, or no device)."""
    red = (traces or {}).get(stretch)
    if not red or red.get("busy_s", 0.0) <= 0:
        return None
    s = red.get("spans", {}).get(name)
    if not s or not s["ops"]:
        return None
    return 100.0 * s["device_s"] / red["busy_s"]
