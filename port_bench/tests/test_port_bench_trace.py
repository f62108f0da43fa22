"""The reduction of a traced stretch (``trace.reduce_trace``) on Chrome
trace events made by hand: busy time as a union, launch calls per step,
and kernels credited to the ``bench:`` ranges open at their launch, also
when a CUDA graph replays them; a replay of a recorded capture credited to
the ``bench:`` and ``tw:`` ranges its kernels were captured in, or read as
nothing where it does not match its capture; and, on every trace here
with no replay of a recorded capture, the same fields as the reductions
before graphs were credited (``frozen_reductions.py``)."""

import pytest

from port_bench import spans
from port_bench import trace as T
from port_bench.tests import frozen_reductions as F
from port_bench.tests import test_port_bench_spans as S


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """Two steps. Step 1 launches its cross attention eagerly (two kernels)
    and an MLP kernel; step 2 replays the cross attention as one graph of
    three kernels inside the same range, then replays a graph of two
    kernels outside it."""
    ev = [_x("user_annotation", "bench:step", 0, 100),
          _x("user_annotation", "bench:cross_attn", 10, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
          _x("cuda_driver", "cuLaunchKernelEx", 20, 2, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=3),
          _x("kernel", "cross_a", 200, 10, corr=1),
          _x("kernel", "cross_b", 215, 5, corr=2),
          _x("kernel", "mlp", 230, 20, corr=3),
          _x("user_annotation", "bench:step", 100, 100),
          _x("user_annotation", "bench:cross_attn", 110, 30),
          _x("cuda_runtime", "cudaGraphLaunch", 115, 3, corr=4),
          _x("cuda_runtime", "cudaGraphLaunch", 150, 3, corr=5),
          _x("kernel", "cross_a", 300, 10, corr=4),
          _x("kernel", "cross_b", 310, 5, corr=4),
          _x("kernel", "cross_c", 320, 4, corr=4),
          _x("kernel", "mlp", 330, 20, corr=5),
          _x("kernel", "mlp_out", 350, 6, corr=5),
          _x("user_annotation", "bench:step", 200, 50)]
    return ev


def test_graph_kernels_belong_to_the_range_open_at_their_launch():
    red = T.reduce_trace(_events(), 1e-3)
    cross = red["ranges"]["cross_attn"]
    assert cross["kernels"] == 5  # 2 eager + 3 replayed
    assert cross["device_s"] == pytest.approx((10 + 5 + 10 + 5 + 4) / 1e6)
    assert red["ranges"]["step"]["kernels"] == 8


def test_a_graph_launch_is_one_launch_call():
    red = T.reduce_trace(_events(), 1e-3)
    assert red["launches"] == 5
    assert red["launches_per_step"] == [3, 2]


def test_busy_is_the_union_of_device_intervals():
    ev = [_x("kernel", "a", 0, 10, corr=1), _x("kernel", "b", 5, 10, corr=2),
          _x("gpu_memcpy", "copy", 30, 5)]
    red = T.reduce_trace(ev, 100e-6)
    assert red["busy_s"] == pytest.approx(20e-6)
    assert T.idle_share(red) == pytest.approx(80.0)


def _capture():
    """The trace of one capture (``bench.capture:0`` on thread 1): a step
    of five node calls inside ``tw:decode.step`` and ``bench:step``:
    a kernel, then two calls of the cross attention (a kernel and a copy;
    a kernel launched through the driver), then a kernel after them."""
    return [_x("user_annotation", "bench.capture:0", 0, 100),
            _x("user_annotation", "tw:decode.step", 5, 85),
            _x("user_annotation", "bench:step", 6, 83),
            _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=91),
            _x("user_annotation", "bench:cross_attn", 20, 12),
            _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=92),
            _x("cuda_runtime", "cudaMemcpyAsync", 30, 2, corr=93),
            _x("user_annotation", "bench:cross_attn", 34, 6),
            _x("cuda_driver", "cuLaunchKernel", 35, 2, corr=94),
            _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=95),
            _x("cuda_runtime", "cudaStreamEndCapture", 95, 1, corr=96)]


BOUND = 2e-6  # what the cross attention wrapper reckoned in the capture


def _graphs():
    rec = T.read_captures(_capture())
    return {gid: dict(r, acc={"cross_attn": BOUND}) for gid, r in rec.items()}


DURS = (10, 4, 3, 5, 7)  # the replay's operations, in the capture's order


def _replays(n=3, drop=None):
    """A decode loop range over ``n`` replays of capture 0, each graph
    launch in a ``bench.replay:0`` range, its five operations after it
    (the ``drop``-th replay without its last)."""
    ev = [_x("user_annotation", "tw:decode.loop", 0, 100 * n + 50)]
    for r in range(n):
        t, corr = 100 * r + 10, 10 + r
        ev += [_x("user_annotation", "bench.replay:0", t, 10),
               _x("cuda_runtime", "cudaGraphLaunch", t + 2, 3, corr=corr)]
        start = 1000 + 100 * r
        for i, (cat, dur) in enumerate(zip(("kernel", "kernel", "gpu_memcpy", "kernel",
                                            "kernel"), DURS)):
            if r == drop and i == len(DURS) - 1:
                break
            ev.append(_x(cat, f"op{i}", start, dur, corr=corr))
            start += dur + 1
    return ev


def test_a_capture_keeps_its_node_calls_and_the_ranges_open_around_each():
    rec = T.read_captures(_capture())["0"]
    assert [n for n, _ in rec["nodes"]] == ["cudaLaunchKernel", "cudaLaunchKernel",
                                           "cudaMemcpyAsync", "cuLaunchKernel",
                                           "cudaLaunchKernel"]
    assert [sorted(o) for _, o in rec["nodes"]][1] == ["bench:cross_attn", "bench:step",
                                                      "tw:decode.step"]
    assert rec["calls"] == {"tw:decode.step": 1, "bench:step": 1, "bench:cross_attn": 2}


def test_a_replay_is_credited_to_the_ranges_it_was_captured_in():
    ev, graphs = _replays(), _graphs()
    red = T.reduce_trace(ev, 1e-3, graphs)
    cross = red["ranges"]["cross_attn"]
    # the two kernels of the cross attention, once per replay; its copy is
    # no launch call's, as in an eager step
    assert cross == {"device_s": pytest.approx(3 * (4 + 5) / 1e6), "kernels": 6, "calls": 6}
    assert red["ranges"]["step"]["kernels"] == 3 * 4
    assert red["graphs"] == {"replays": 3, "unmatched": 0,
                             "acc": {"cross_attn": pytest.approx(3 * BOUND)}}
    tw = spans.reduce_spans(ev, graphs)
    assert tw["decode.step"] == {"calls": 3, "device_s": pytest.approx(3 * sum(DURS) / 1e6),
                                 "ops": 15}
    assert tw["decode.loop"] == tw["decode.step"] | {"calls": 1}  # open at each launch
    assert "cross_attn" not in tw and "decode.step" not in red["ranges"]


def test_a_graph_over_one_step_gives_one_launch_a_step():
    red = T.reduce_trace(_replays(5), 1e-3, _graphs())
    assert red["launches"] == 5
    assert red["launches_per_step"] == [1, 1, 1, 1]
    assert T.launches_per_step({"loop": red}, skip=0) == 1.0


def test_a_replay_that_does_not_match_its_capture_reads_nothing():
    ev, graphs = _replays(drop=1), _graphs()
    red = T.reduce_trace(ev, 1e-3, graphs)
    assert red["graphs"]["unmatched"] == 1 and red["graphs"]["replays"] == 3
    assert red["ranges"]["cross_attn"]["kernels"] is None
    assert red["ranges"]["cross_attn"]["device_s"] is None
    red["acc"] = red["graphs"]["acc"]
    assert T.range_roofline({"loop": red}, "cross_attn") is None
    tw = spans.reduce_spans(ev, graphs)
    assert tw["decode.step"]["ops"] is None and tw["decode.step"]["device_s"] is None
    # the range open at the graph launch still holds every operation
    assert tw["decode.loop"]["ops"] == 14
    red["spans"] = tw
    assert spans.device_share({"loop": red}, "loop", "decode.step") is None


def test_an_unrecorded_graph_is_credited_as_before():
    ev = _replays()
    red = T.reduce_trace(ev, 1e-3, {"0": {"acc": {"cross_attn": BOUND}}})
    assert "graphs" not in red and "cross_attn" not in red["ranges"]
    assert spans.reduce_spans(ev)["decode.loop"]["ops"] == 15


def _mirrored():
    """Nested ranges, another thread's kernel and eager kernels, and two
    replays of capture 0 (with its copy left out: an eager copy would be
    credited by ``tw:`` ranges alone), all ranges named ``P:<name>``; and
    the capture's trace, named so too."""
    ev = [_x("user_annotation", "P:outer", 300, 100),
          _x("user_annotation", "P:inner", 305, 30),
          _x("user_annotation", "P:inner", 308, 4),  # nested in the first
          _x("cuda_runtime", "cudaLaunchKernel", 309, 1, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 320, 1, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 321, 1, tid=2, corr=3),
          _x("user_annotation", "P:inner", 340, 30, tid=2),
          _x("cuda_runtime", "cudaLaunchKernel", 350, 1, corr=4),
          _x("kernel", "a", 500, 3, corr=1),
          _x("kernel", "b", 504, 5, corr=2),
          _x("kernel", "c", 510, 7, corr=3),
          _x("kernel", "d", 520, 11, corr=4)]
    ev += [e for e in _replays(2) if e["name"] != "tw:decode.loop" and e["cat"] != "gpu_memcpy"]
    cap = [e for e in _capture() if e["name"] != "cudaMemcpyAsync"]

    def named(events):
        return [dict(e, name=e["name"].replace("bench:", "P:").replace("tw:", "P:"))
                for e in events]
    return named(ev), named(cap)


@pytest.mark.parametrize("replays", [False, True])
def test_the_bench_and_tw_rules_agree(replays):
    ev, cap = _mirrored()
    got = {}
    for prefix in ("bench:", "tw:"):
        graphs = ({g: dict(r, acc={}) for g, r in
                   T.read_captures(_renamed(cap, prefix)).items()} if replays else None)
        if prefix == "bench:":
            red = T.reduce_trace(_renamed(ev, prefix), 1e-3, graphs)
            got[prefix] = {n: (r["calls"], r["device_s"], r["kernels"])
                           for n, r in red["ranges"].items()}
        else:
            got[prefix] = {n: (r["calls"], r["device_s"], r["ops"]) for n, r in
                           spans.reduce_spans(_renamed(ev, prefix), graphs).items()}
    assert got["bench:"] == got["tw:"]
    assert got["tw:"]["outer"] == (1, pytest.approx(19e-6), 3)
    assert got["tw:"]["inner"] == (3, pytest.approx(8e-6), 2)
    if replays:
        assert got["tw:"]["cross_attn"] == (4, pytest.approx(2 * 9e-6), 4)
        assert got["tw:"]["decode.step"] == (2, pytest.approx(2 * 26e-6), 8)
    else:
        assert set(got["tw:"]) == {"outer", "inner"}


def _busy():
    return [_x("kernel", "a", 0, 10, corr=1), _x("kernel", "b", 5, 10, corr=2),
            _x("gpu_memcpy", "copy", 30, 5)]


def _renamed(events, prefix):
    return [dict(e, name=e["name"].replace("P:", prefix)) for e in events]


TRACES = {"graph_launches": _events, "busy": _busy, "spans": S._events,
          "mirrored_tw": lambda: _renamed(_mirrored()[0], "tw:"),
          "unrecorded_replays": _replays, "capture": _capture}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_a_trace_without_a_recorded_capture_reduces_as_before(name):
    ev = TRACES[name]()
    assert T.reduce_trace(ev, 1e-3) == F.reduce_trace(ev, 1e-3)
    assert T.reduce_trace(ev, 1e-3, {}) == F.reduce_trace(ev, 1e-3)
    assert spans.reduce_spans(ev) == F.reduce_spans(ev)
    wrapped = spans._with_spans(T.reduce_trace)(ev, 1e-3)
    assert wrapped == dict(F.reduce_trace(ev, 1e-3), spans=F.reduce_spans(ev))


def test_a_bench_range_nested_in_itself_now_reads_as_a_tw_range_does():
    """Where one ``bench:`` range nests in itself on a thread, the old rule
    looked only at the instance that began last, and missed a kernel
    launched in the outer one after the inner one closed; the one rule
    merges them, as ``tw:`` ranges always were. No range of the cells
    nests in itself (``bench:step``, ``cross_attn``, ``enc_attn``,
    ``dec_attn``)."""
    ev = _renamed(_mirrored()[0], "bench:")
    new, old = T.reduce_trace(ev, 1e-3), F.reduce_trace(ev, 1e-3)
    assert old["ranges"]["inner"] == {"calls": 3, "device_s": pytest.approx(3e-6), "kernels": 1}
    assert new["ranges"]["inner"] == {"calls": 3, "device_s": pytest.approx(8e-6), "kernels": 2}
    assert dict(new, ranges=None) == dict(old, ranges=None)
    assert new["ranges"]["outer"] == old["ranges"]["outer"]
