"""The port's own ``tw:`` ranges in a traced stretch.

While a profiler records, each span of ``taiwan_whisper_tpu_torch/utils/
profiling.py`` opens ``record_function("tw:<name>")``. ``reduce_spans``
credits device time to those ranges by the rule that ``trace.py`` applies
to the benchmark's ``bench:`` ranges (``trace.attribute``): a device
operation (kernel, copy or set) belongs to a range when the runtime call
that launched it, matched by CUPTI's correlation id, lies inside one of the
range's instances on the same host thread. Every operation of a replayed
CUDA graph carries the correlation id of its graph launch: it belongs to
the ranges open at that launch and, where the replay is of a capture that
``trace.Graphs`` recorded, to the ranges it was captured in (``None``
where the replay's operations do not match its capture's node calls one
to one). Ranges nest: a kernel launched inside ``tw:decode.step`` inside
``tw:decode.loop`` counts in both.

``install(ctx)``, called by the metric files that read ranges, wraps
``trace.reduce_trace`` for the run, so that each stretch's reduction also
holds ``spans``: ``{name: {"calls", "device_s", "ops"}}``. A program
without the spans (an older commit of the port) leaves it empty, and the
metrics read nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from port_bench import trace

PREFIX = "tw:"


def reduce_spans(events: List[dict], graphs: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
    """``{name: {"calls": instances, "device_s": device seconds credited,
    "ops": device operations credited}}`` of every ``tw:`` range in the
    Chrome trace events (times in us); ``graphs``: the records of the
    captures that the events may replay (``trace.Graphs.records``). Any
    runtime call credits the operation it launched."""
    return trace.attribute(events, PREFIX, lambda name: True, graphs)[0]


def _with_spans(orig):
    def reduce_trace(events, window_s, graphs=None):
        red = orig(events, window_s, graphs)
        red["spans"] = reduce_spans(events, graphs)
        return red

    reduce_trace.with_spans = True
    return reduce_trace


def install(ctx):
    """Wrap ``trace.reduce_trace`` for the run (once, however many metric
    files ask)."""
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
