"""The reduction of a traced stretch (``trace.reduce_trace``) on Chrome
trace events made by hand: busy time as a union, launch calls per step,
and kernels credited to the ``bench:`` ranges open at their launch, also
when a CUDA graph replays them."""

import pytest

from port_bench import trace as T


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
