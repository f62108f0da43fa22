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

``Graphs`` records each CUDA graph that the port captures while a run
traces (``torch.cuda.CUDAGraph``'s ``capture_begin``, ``capture_end`` and
``replay``, wrapped for the run): the capture runs under the same Kineto
set-up as a stretch (or inside the stretch being traced), in a
``bench.capture:<id>`` range, and each replay under a profiler runs in a
``bench.replay:<id>`` range. From the capture's trace it keeps, in order,
the runtime calls that made a node of the graph (a kernel launch, a copy
or a set) with the ``bench:`` and ``tw:`` ranges open on the capturing
thread around each, and the instances of each range; from the range
wrappers, the bounds they reckoned inside the capture (``acc``).

``reduce_trace`` works on the exported Chrome trace alone, and on those
records:

* busy seconds: the union of the device's kernel, copy and set intervals
  (overlapping streams are counted once);
* launch calls: host runtime calls whose name starts with ``cudaLaunch``
  or ``cuLaunch`` (what ``tools/profile_label.py`` counts), and graph
  launches (``cudaGraphLaunch``, ``cuGraphLaunch``): a replayed CUDA graph
  is one launch call, however many kernels it holds;
* ranges: ``record_function`` ranges named ``bench:<name>`` that the
  benchmark's own files open around calls into the port, credited by
  ``attribute`` (the rule that ``spans.py`` applies to the port's ``tw:``
  ranges too): a device operation belongs to a range when the runtime call
  that launched it (matched by CUPTI's correlation id) lies inside one of
  the range's instances on the same host thread. Every operation of a
  replayed graph carries the correlation id of its graph launch: it
  belongs to the ranges open at that launch and, where the replay is of a
  recorded capture, to the ranges it was captured in: the replay's
  operations, ordered by start, map one to one onto the capture's node
  calls. A replay whose operation count differs from its capture's leaves
  each range it was captured in unread for the take (``None``), and is
  counted in ``graphs["unmatched"]``. Each replay adds its capture's
  instances to each range's calls and its bounds to ``acc``;
* per step: launch calls between the starts of consecutive
  ``bench:step`` ranges; a replay whose capture held k of them starts k
  steps at its launch;
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
from typing import Callable, Dict, List, Optional, Tuple

import torch

TRIES = 3
STEP_RANGE = "bench:step"
RANGE_PREFIXES = ("bench:", "tw:")
CAPTURE, REPLAY = "bench.capture:", "bench.replay:"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
_NODE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
_HOST_NODES = ("cudaLaunchHostFunc", "cuLaunchHostFunc")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")
_GRAPH_ID = "_port_bench_graph"


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _kineto_start(device: torch.device):
    """Kineto on: CPU and, on a card, CUDA activities; the user scope only."""
    from torch._C._profiler import RecordScope
    from torch.autograd import _enable_profiler, _prepare_profiler

    prof = torch.autograd.profiler.profile(use_kineto=True,
                                           use_device="cuda" if device.type == "cuda" else None)
    cfg = prof.config()
    _prepare_profiler(cfg, prof.kineto_activities)
    _enable_profiler(cfg, prof.kineto_activities, {RecordScope.USER_SCOPE})
    return prof


def _kineto_stop(path: str) -> List[dict]:
    """Kineto off; the Chrome trace events it recorded."""
    from torch.autograd import _disable_profiler

    result = _disable_profiler()
    result.save(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    return events


class Stretch:
    """One traced stretch at a time. ``result`` holds the reduction of the
    first take that traced a kernel, with ``acc``: the sums that the
    metrics' wrappers add up (bounds from shapes) while the take runs, and
    those of the recorded captures that the take replayed."""

    def __init__(self, name: str, workdir: str, device: torch.device,
                 graphs: Optional["Graphs"] = None):
        self.name = name
        self.workdir = workdir
        self.device = device
        self.graphs = graphs
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
        self._sync()
        self.acc = defaultdict(float)
        self.prof = _kineto_start(self.device)
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof = None
        self.tries += 1
        events = _kineto_stop(os.path.join(self.workdir, f"trace_{self.name}_{self.tries}.json"))
        records = None
        if self.graphs is not None:
            self.graphs.read(events)  # a capture made inside this take
            records = self.graphs.records
        red = reduce_trace(events, wall, records)
        red["acc"] = dict(self.acc)
        for name, bound in red.get("graphs", {}).get("acc", {}).items():
            red["acc"][name] = red["acc"].get(name, 0.0) + bound
        if red["kernels"] > 0 or self.device.type != "cuda":
            self.result = red


class _Capture:
    """A capture being recorded: what the range wrappers add up in it."""

    def __init__(self, gid: str):
        self.gid = gid
        self.acc: Dict[str, float] = defaultdict(float)
        self.range = None  # its bench.capture:<id> record_function
        self.own_session = False


class Graphs:
    """The CUDA graphs captured while a traced run records them.
    ``records[id]``: ``acc`` (bounds the range wrappers reckoned inside the
    capture) and, once its trace is read, ``nodes`` (each node call's name
    and the ranges open around it, in order) and ``calls`` (instances of
    each range inside the capture). ``capturing`` is the capture being
    recorded now: the range wrappers add their bounds to it, and drivers
    neither start nor stop a stretch (which synchronises) inside it."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.records: Dict[str, dict] = {}
        self.capturing: Optional[_Capture] = None

    def install(self, cls=None):
        """Wrap ``cls`` (``torch.cuda.CUDAGraph``) for the run."""
        cls = cls or torch.cuda.CUDAGraph
        self.ctx.patch(cls, "capture_begin", self._capture_begin)
        self.ctx.patch(cls, "capture_end", self._capture_end)
        self.ctx.patch(cls, "replay", self._replay)

    def _wanted(self) -> bool:
        """Whether a later take may still replay what is captured now."""
        st = self.ctx.stretches.values()
        return not st or any(s.active or s.wanted for s in st)

    def _capture_begin(self, orig):
        def capture_begin(graph, *args, **kwargs):
            cap = _Capture(str(len(self.records)))
            setattr(graph, _GRAPH_ID, cap.gid)
            self.records[cap.gid] = {"acc": {}}
            if self._wanted() and not _profiling():
                _kineto_start(self.ctx.device)  # before the stream begins capturing
                cap.own_session = True
            try:
                orig(graph, *args, **kwargs)
            except BaseException:
                self._close(cap)
                raise
            if _profiling():
                cap.range = torch.profiler.record_function(CAPTURE + cap.gid)
                cap.range.__enter__()
            self.capturing = cap
        return capture_begin

    def _capture_end(self, orig):
        def capture_end(graph, *args, **kwargs):
            cap, self.capturing = self.capturing, None
            try:
                orig(graph, *args, **kwargs)
            finally:
                if cap is not None:
                    self._close(cap)
        return capture_end

    def _close(self, cap: _Capture):
        if cap.range is not None:
            cap.range.__exit__(None, None, None)
        self.records[cap.gid]["acc"] = dict(cap.acc)
        if cap.own_session:
            self.read(_kineto_stop(os.path.join(self.ctx.workdir, f"capture_{cap.gid}.json")))

    def _replay(self, orig):
        def replay(graph, *args, **kwargs):
            gid = graph_id(graph)
            if gid is None or not _profiling():
                return orig(graph, *args, **kwargs)
            with torch.profiler.record_function(REPLAY + gid):
                return orig(graph, *args, **kwargs)
        return replay

    def read(self, events: List[dict]):
        """Complete the records of the captures that ``events`` hold."""
        for gid, found in read_captures(events).items():
            self.records.setdefault(gid, {"acc": {}}).update(found)


def graph_id(graph) -> Optional[str]:
    """The id ``Graphs`` gave a graph it saw captured, or None."""
    return getattr(graph, _GRAPH_ID, None)


def watch_graphs(ctx) -> Graphs:
    """The run's ``Graphs`` (``ctx.graphs``), made and installed once."""
    if ctx.graphs is None:
        ctx.graphs = Graphs(ctx)
        ctx.graphs.install()
        for s in ctx.stretches.values():
            s.graphs = ctx.graphs
    return ctx.graphs


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class _Held:
    """The instances of named ranges on each host thread, nested ones
    merged: which are open at a time on a thread."""

    def __init__(self, by_name: Dict[str, Dict[object, list]]):
        self.held = {n: {tid: _union(iv) for tid, iv in by_tid.items()}
                     for n, by_tid in by_name.items()}
        self.starts = {n: {tid: [a for a, _ in iv] for tid, iv in by_tid.items()}
                       for n, by_tid in self.held.items()}

    def open_at(self, ts: float, tid) -> List[str]:
        out = []
        for n, by_tid in self.held.items():
            iv = by_tid.get(tid)
            if iv is None:
                continue
            i = bisect.bisect_right(self.starts[n][tid], ts) - 1
            if i >= 0 and iv[i][1] >= ts:
                out.append(n)
        return out


def _user_ranges(events: List[dict], prefixes: Tuple[str, ...]) -> Dict[str, Dict[object, list]]:
    ranges: Dict[str, Dict[object, list]] = defaultdict(lambda: defaultdict(list))
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith(prefixes):
            ts = float(e.get("ts", 0.0))
            ranges[name][e.get("tid")].append((ts, ts + float(e.get("dur", 0.0))))
    return ranges


def read_captures(events: List[dict]) -> Dict[str, dict]:
    """``{id: {"nodes": [[call name, [ranges open]], ...], "calls": {range:
    instances}}}`` of each ``bench.capture:<id>`` range in the events: the
    calls on its thread inside it that made a node of the graph (a launch,
    copy or set: the range opens once the stream captures), in order, and
    the ``bench:`` and ``tw:`` ranges (full names) open around each and
    begun inside it."""
    markers = _user_ranges(events, (CAPTURE,))
    if not markers:
        return {}
    raw = _user_ranges(events, RANGE_PREFIXES)
    held = _Held(raw)
    calls = sorted((float(e.get("ts", 0.0)), e.get("tid"), e.get("name", "")) for e in events
                   if e.get("ph") == "X" and e.get("cat") in _RUNTIME_CATS
                   and e.get("name", "").startswith(_NODE_CALLS)
                   and not e.get("name", "").startswith(_HOST_NODES))
    out = {}
    for marker, by_tid in markers.items():
        for tid, iv in by_tid.items():
            for a, b in iv:
                nodes = [[name, held.open_at(ts, tid)] for ts, t, name in calls
                         if t == tid and a <= ts <= b]
                begun = {n: k for n, k in ((n, sum(a <= x <= b for x, _ in by.get(tid, ())))
                                           for n, by in raw.items()) if k}
                out[marker[len(CAPTURE):]] = {"nodes": nodes, "calls": begun}
    return out


def attribute(events: List[dict], prefix: str, credits: Callable[[str], bool],
              graphs: Optional[Dict[str, dict]] = None) -> Tuple[Dict[str, dict], dict]:
    """The one rule by which ``reduce_trace`` (``bench:``) and
    ``spans.reduce_spans`` (``tw:``) credit device operations to ranges
    (see the module docstring). ``credits``: whether a runtime call of that
    name, made eagerly or captured into a graph, credits the operation it
    made. Returns ``{name without prefix: {"calls", "device_s", "ops"}}``
    (``device_s`` and ``ops`` None for a range that an unmatched replay
    leaves unread) and ``{"replays": [(launch start, id), ...],
    "unmatched": n}`` for the replays of recorded captures."""
    graphs = graphs or {}

    def ours(names):
        return [n[len(prefix):] for n in names if n.startswith(prefix)]

    raw = {n[len(prefix):]: by_tid for n, by_tid in _user_ranges(events, (prefix,)).items()}
    held = _Held(raw)
    markers = _user_ranges(events, (REPLAY,))
    launched = {}  # correlation id -> (start of the runtime call, its thread)
    graph_launches = []
    device = []  # (duration, correlation id, start), in the events' order
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        cat, name, ts = e.get("cat", ""), e.get("name", ""), float(e.get("ts", 0.0))
        if cat in _RUNTIME_CATS and credits(name):
            launched[corr] = (ts, e.get("tid"))
            if name.startswith(_GRAPH_LAUNCHES):
                graph_launches.append((ts, e.get("tid"), corr))
        elif cat in _DEVICE_CATS:
            device.append((float(e.get("dur", 0.0)), corr, ts))

    # a graph launch inside a bench.replay:<id> range on its thread replays
    # that capture, if the capture's trace was read
    replay_of = {}
    for ts, tid, corr in graph_launches:
        for marker, by_tid in markers.items():
            gid = marker[len(REPLAY):]
            if "nodes" in graphs.get(gid, {}) and any(a <= ts <= b
                                                      for a, b in by_tid.get(tid, ())):
                replay_of[corr] = (ts, gid)
    replayed = defaultdict(list)  # graph launch -> its operations' (start, index)
    for i, (_, corr, start) in enumerate(device):
        if corr in replay_of:
            replayed[corr].append((start, i))
    captured = {}  # index into device -> the ranges its node was captured in
    unread, unmatched = set(), 0
    for corr, (_, gid) in replay_of.items():
        nodes = graphs[gid]["nodes"]
        if len(replayed[corr]) != len(nodes):
            unmatched += 1
            unread |= ({n for _, opened in nodes for n in ours(opened)}
                       - set(held.open_at(*launched[corr])))
            continue
        for (_, i), (call, opened) in zip(sorted(replayed[corr]), nodes):
            if credits(call):
                captured[i] = ours(opened)

    out = defaultdict(lambda: {"calls": 0, "device_s": 0.0, "ops": 0})
    for n, by_tid in raw.items():
        out[n]["calls"] = sum(len(iv) for iv in by_tid.values())
    for _, gid in replay_of.values():
        for n, k in graphs[gid]["calls"].items():
            if n.startswith(prefix):
                out[n[len(prefix):]]["calls"] += k
    for i, (dur, corr, _) in enumerate(device):
        hit = launched.get(corr)
        if hit is None:
            continue
        names = held.open_at(*hit)
        for n in names + [n for n in captured.get(i, ()) if n not in names]:
            out[n]["device_s"] += dur
            out[n]["ops"] += 1
    for n in unread:
        out[n].update(device_s=None, ops=None)
    for r in out.values():
        if r["device_s"] is not None:
            r["device_s"] /= 1e6
    return dict(out), {"replays": sorted(replay_of.values()), "unmatched": unmatched}


def _is_launch(name: str) -> bool:
    return name.startswith(_LAUNCHES)


def reduce_trace(events: List[dict], window_s: float,
                 graphs: Optional[Dict[str, dict]] = None) -> dict:
    """The stretch's numbers from its Chrome trace events (times in us) and
    the records of the captures it may replay (``Graphs.records``)."""
    device, host, launches, steps = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur, name))
        elif cat in _RUNTIME_CATS:
            host.append((ts, ts + dur, name, e.get("tid")))
            if _is_launch(name):
                launches.append(ts)
        elif cat in _HOST_CATS:
            host.append((ts, ts + dur, name, e.get("tid")))
            if cat == "user_annotation" and name == STEP_RANGE:
                steps.append(ts)

    busy = _union([(a, b) for a, b, _ in device])
    busy_us = sum(b - a for a, b in busy)

    ranged, replays = attribute(events, "bench:", _is_launch, graphs)
    range_device = {n: {"device_s": s["device_s"], "kernels": s["ops"], "calls": s["calls"]}
                    for n, s in ranged.items()}
    for ts, gid in replays["replays"]:
        steps += [ts] * graphs[gid]["calls"].get(STEP_RANGE, 0)

    step_starts = sorted(steps)
    per_step = []
    if len(step_starts) >= 2:
        lt = sorted(launches)
        for s0, s1 in zip(step_starts, step_starts[1:]):
            per_step.append(bisect.bisect_left(lt, s1) - bisect.bisect_left(lt, s0))

    ops = defaultdict(float)
    for a, b, name in device:
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

    red = {"window_s": window_s, "busy_s": busy_us / 1e6, "kernels": len(device),
           "launches": len(launches), "launches_per_step": per_step,
           "ranges": range_device, "device_ops": [[k, v] for k, v in device_ops],
           "idle_gaps": idle}
    if replays["replays"]:
        acc = defaultdict(float)
        for _, gid in replays["replays"]:
            for n, bound in graphs[gid]["acc"].items():
                acc[n] += bound
        red["graphs"] = {"replays": len(replays["replays"]),
                         "unmatched": replays["unmatched"], "acc": dict(acc)}
    return red


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
