"""The port's ``tw:`` ranges in a traced stretch (``spans.py``) on Chrome
trace events made by hand: nested ranges, another thread's kernels, a
graph launch; and the six metrics that read the port's spans and counters
on the tiny CPU cells: the program's non-null, the device trace's none
where the CPU has no device operation (as ``trace.py``'s own shares), and
none of them raising on a program that has no spans."""

import os
import time

import pytest
import torch

from port_bench import harness, spans
from port_bench import trace as T

LABEL, DISTILL = "label.large-v2.greedy", "distill.32-2.b32"
PROGRAM = ("decode.loop_share", "decode.step_host_ms", "decode.select_host_ms",
           "decode.live_row_share")
DEVICE = ("train_step.teacher_share", "train_step.encoder_share")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """A loop range holding two step ranges on thread 1; a kernel launched
    by thread 2 while they are open; a graph of two kernels launched in the
    second step; a copy launched in the loop between the steps; and a
    nested second instance of the step range inside the first."""
    return [_x("user_annotation", "tw:decode.loop", 0, 100),
            _x("user_annotation", "tw:decode.step", 10, 20),
            _x("user_annotation", "tw:decode.step", 12, 5),  # nested in the first
            _x("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=1),
            _x("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=2),
            _x("cuda_runtime", "cudaMemcpyAsync", 40, 2, corr=3),
            _x("user_annotation", "tw:decode.step", 50, 20),
            _x("cuda_runtime", "cudaGraphLaunch", 55, 3, corr=4),
            _x("cuda_runtime", "cudaLaunchKernel", 56, 1, tid=2, corr=5),
            _x("user_annotation", "bench:step", 50, 20),
            _x("kernel", "a", 200, 10, corr=1),
            _x("kernel", "b", 210, 4, corr=2),
            _x("gpu_memcpy", "copy", 220, 6, corr=3),
            _x("kernel", "g1", 230, 3, corr=4),
            _x("kernel", "g2", 233, 2, corr=4),
            _x("kernel", "other_thread", 240, 50, corr=5),
            _x("gpu_user_annotation", "tw:decode.step", 200, 14)]


def test_nested_ranges_each_hold_their_kernels():
    red = spans.reduce_spans(_events())
    assert red["decode.loop"] == {"calls": 1, "device_s": pytest.approx((10 + 4 + 6 + 5) / 1e6),
                                  "ops": 5}
    # the nested instance adds a call but credits no kernel twice
    assert red["decode.step"]["calls"] == 3
    assert red["decode.step"]["ops"] == 4
    assert red["decode.step"]["device_s"] == pytest.approx((10 + 4 + 3 + 2) / 1e6)
    assert set(red) == {"decode.loop", "decode.step"}  # bench: ranges are trace.py's


def test_another_threads_kernels_are_not_credited():
    red = spans.reduce_spans(_events())
    assert all(s["device_s"] < 50e-6 for s in red.values())


def test_a_graphs_kernels_belong_to_the_ranges_open_at_its_launch():
    ev = [e for e in _events() if e.get("args", {}).get("correlation") in (None, 4)]
    red = spans.reduce_spans(ev)
    assert red["decode.step"]["ops"] == red["decode.loop"]["ops"] == 2
    assert red["decode.step"]["device_s"] == pytest.approx(5e-6)


def test_the_share_is_of_the_stretchs_busy_time():
    red = T.reduce_trace(_events(), 1e-3)
    red["spans"] = spans.reduce_spans(_events())
    traces = {"step": red}
    assert spans.device_share(traces, "step", "decode.loop") == pytest.approx(
        100.0 * 25 / (red["busy_s"] * 1e6))
    assert spans.device_share(traces, "step", "train.teacher") is None
    red["busy_s"] = 0.0
    assert spans.device_share(traces, "step", "decode.loop") is None


def test_install_wraps_reduce_trace_once(tiny_root):
    p = harness.plan(tiny_root, DISTILL)
    ctx = harness.Ctx(p, seed=1, seconds=1.0, trace=True, device=torch.device("cpu"),
                      workdir=tiny_root)
    orig = T.reduce_trace
    spans.install(ctx)
    spans.install(ctx)
    assert len(ctx._patches) == 1 and "spans" in T.reduce_trace(_events(), 1e-3)
    ctx.unpatch()
    assert T.reduce_trace is orig


def _record(root, cell):
    """One window of a tiny cell traced on the CPU, without its check:
    the record its metrics read, and the metric modules."""
    p = harness.plan(root, cell)
    mods = harness.load_metrics(p)
    ctx = harness.Ctx(p, seed=3000000019, seconds=1.0, trace=True, device=torch.device("cpu"),
                      workdir=os.path.join(root, "work_" + cell))
    os.makedirs(ctx.workdir)
    try:
        for m in mods.values():
            if hasattr(m, "install"):
                m.install(ctx)
        out = harness.load_driver(p).run(ctx, t_start=time.time())
    finally:
        ctx.unpatch()
    return dict(out["record"], trace=ctx.traces()), mods


def test_program_metrics_read_the_label_cell(tiny_root, one_thread):
    rec, mods = _record(tiny_root, LABEL)
    got = {n: mods[n].read(rec) for n in PROGRAM}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["decode.loop_share"] < 100 and got["decode.live_row_share"] <= 100
    st = rec["stats"]
    assert got["decode.step_host_ms"] == pytest.approx(
        1e3 * st["spans"]["decode.step"]["seconds"] / st["counts"]["decode.steps"])
    # a program without spans and counters: nothing read, nothing raised
    bare = dict(rec, stats={k: v for k, v in st.items() if k not in ("spans", "counts")})
    assert all(mods[n].read(bare) is None for n in PROGRAM)


def test_device_metrics_on_the_cpu_read_as_the_trace_does(tiny_root, one_thread):
    rec, mods = _record(tiny_root, DISTILL)
    red = rec["trace"]["step"]
    # the host ranges are there; the CPU gives them no device operation,
    # so the shares read nothing, as trace.py's range rooflines do
    assert red["spans"]["train.teacher"]["calls"] == red["spans"]["train.encode"]["calls"] > 0
    assert red["spans"]["train.teacher"]["ops"] == 0 and red["busy_s"] == 0
    assert T.range_roofline(rec["trace"], "enc_attn") is None
    assert all(mods[n].read(rec) is None for n in DEVICE)
    assert all(mods[n].read(dict(rec, trace={"step": {k: v for k, v in red.items()
                                                       if k != "spans"}})) is None
               for n in DEVICE)

