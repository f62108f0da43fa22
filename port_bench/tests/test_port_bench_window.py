"""The train window and the readings beside it, on the tiny CPU
distillation cell: ``setup_s`` ends at the synchronisation before step 4,
the window opens there and closes after the first step that ends
``--seconds`` after it opens, and the reference still follows steps 1-3.
The driver's clock is a fake one that each step of the port moves by one
second, so every count and time is exact. The card's reader
(``card.py``) takes no reading and raises nothing without NVML, and sums
up what a fake NVML gives; the host's readings (``host.py``) likewise
without ``/proc``."""

import contextlib
import io
import json
import time
import types

import pytest
import torch

from port_bench import card, harness, host, run

DISTILL = "distill.32-2.b32"
BATCH = 4  # the tiny traffic's batch


class _Clock:
    """``time.perf_counter`` and ``time.time`` that move only by ``tick``."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def time(self):
        return 1e9 + self.now

    def tick(self, s):
        self.now += s


@pytest.mark.parametrize("seconds,window_steps", [(1.0, 1), (2.5, 3)])
def test_setup_ends_at_step_3_and_the_window_closes_after_seconds(tiny_root, one_thread,
                                                                  monkeypatch, seconds,
                                                                  window_steps):
    """Steps take 1 s each. Set-up ends at the start of step 4 (3 s), where
    the window opens; it closes after the first step that ends
    ``seconds`` after it opened, and no step runs after that one."""
    from taiwan_whisper_tpu_torch.pipeline import distill_driver as DD

    clock = _Clock()
    driver = harness.load_driver(harness.plan(tiny_root, DISTILL))
    monkeypatch.setattr(driver, "time", types.SimpleNamespace(perf_counter=clock.perf_counter,
                                                              time=clock.time))
    starts = []  # the fake time at which each step of the port starts
    orig = DD.make_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def timed(*a):
            starts.append(clock.now)
            out = step(*a)
            clock.tick(1.0)
            return out
        return timed
    monkeypatch.setattr(DD, "make_train_step", make)

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", DISTILL, "--seed", "3000000021", "--seconds", str(seconds),
                       "--trace", "0"], device="cpu", root=tiny_root, t_start=clock.time())
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    win = json.loads(next(line for line in err.getvalue().splitlines()
                          if line.startswith("port_bench.train "))[len("port_bench.train "):])

    assert res["correct"], res["checks"]  # the reference follows steps 1-3
    assert res["metrics"]["setup_s"]["value"] == 3.0  # the sync before step 4
    assert starts == [float(i) for i in range(3 + window_steps)]
    assert res["attempted"] == window_steps
    assert res["metrics"]["train_samples_per_s"]["value"] == BATCH  # a step a second
    assert win["launch_ms"] == [1000.0] * window_steps
    assert win["step_ms"] == [] and win["card"] is None  # no CUDA, no NVML on the CPU
    assert win["data_wait_s"] == 0.0 and "MainThread" in win["host"]["threads"]


def test_the_reader_without_nvml_reads_nothing(monkeypatch):
    """No ``libnvidia-ml``, an NVML that does not start, or no CUDA
    device: no thread, no reading, nothing raised."""
    s = card.Sampler(torch.device("cpu"), 0.01)
    s.close()
    assert s.readings == [] and s.between(0.0, 1e9) is None

    def missing(name):
        raise OSError(f"{name}: cannot open shared object file")
    monkeypatch.setattr(card.ctypes, "CDLL", missing)
    s = card.Sampler(torch.device("cuda:0"), 0.01)
    assert s._thread is None
    s.close()
    assert s.between(0.0, 1e9) is None

    monkeypatch.setattr(card.ctypes, "CDLL", lambda name: _fake_nvml(init_rc=9))
    s = card.Sampler(torch.device("cuda:0"), 0.01)
    assert s._thread is None
    s.close()
    s.close()
    assert s.between(0.0, 1e9) is None


def _fake_nvml(init_rc=0, mhz=1755, mw=690500, temp=61, bits=0x4):
    def put(value):
        def fn(*args):
            args[-1]._obj.value = value
            return 0
        return fn
    lib = types.SimpleNamespace(
        nvmlInit_v2=lambda: init_rc, nvmlShutdown=lambda: 0,
        nvmlDeviceGetHandleByPciBusId_v2=lambda bus, h: 0,
        nvmlDeviceGetHandleByIndex_v2=lambda i, h: 0,
        nvmlDeviceGetClockInfo=put(mhz), nvmlDeviceGetPowerUsage=put(mw),
        nvmlDeviceGetTemperature=put(temp), nvmlDeviceGetCurrentClocksThrottleReasons=put(bits))
    return lib


def test_the_reader_sums_up_the_window(monkeypatch):
    """A fake NVML (an older one, with the throttle-reason call): the
    thread reads until closed, and ``between`` sums up the readings inside
    the window only."""
    monkeypatch.setattr(card.ctypes, "CDLL", lambda name: _fake_nvml())
    monkeypatch.setattr(card, "_pci_bus_id", lambda device: None)
    s = card.Sampler(torch.device("cuda:0"), 0.005)
    for _ in range(1000):
        if len(s.readings) >= 3:
            break
        s._stop.wait(0.005)
    s.close()
    assert not s._thread and len(s.readings) >= 3
    assert s.readings[0][1:] == (1755.0, 690.5, 61.0, 0x4)

    s.readings = [(1.0, 1980.0, 300.0, 40.0, 0x0), (2.0, 1700.0, 700.0, 50.0, 0x4),
                  (3.0, 1600.0, 699.0, 55.0, 0x4 | 0x20), (4.0, None, None, None, None),
                  (9.0, 1200.0, 700.0, 80.0, 0x40)]
    w = s.between(1.5, 4.5)
    assert w["readings"] == 3 and w["sm_clock_mhz"] == 1650.0
    assert (w["sm_clock_mhz_min"], w["sm_clock_mhz_max"]) == (1600.0, 1700.0)
    assert w["power_w"] == 699.5 and w["temp_c"] == [50.0, 55.0]
    assert w["reasons"] == {"sw_power_cap": 1.0, "sw_thermal": 0.5}
    assert s.between(4.5, 8.0) is None


def test_the_clock_metric_reads_the_window_or_nothing():
    mod = harness.load_metrics(harness.plan(run.ROOT, DISTILL))["device.sm_clock_mhz.train"]
    assert mod.read({"card": {"sm_clock_mhz": 1712.5}}) == 1712.5
    assert mod.read({"card": None}) is None and mod.read({}) is None


def test_the_host_readings_and_without_proc(monkeypatch):
    """``host.snapshot`` and ``delta`` here: the main thread's CPU seconds
    grow with the work it does; without ``/proc`` there are no threads,
    and nothing raises."""
    a = host.snapshot()
    t = time.process_time()
    while time.process_time() - t < 0.3:
        pass
    d = host.delta(a, host.snapshot())
    assert d["wall_s"] > 0 and d["threads"]["MainThread"] >= 0.2

    def no_proc(path):
        raise FileNotFoundError(path)
    monkeypatch.setattr(host.os, "listdir", no_proc)
    a = host.snapshot()
    assert a["threads"] == {}
    assert host.delta(a, a) == {"wall_s": 0.0, "threads": {}}
