"""The card's SM clock, power draw, temperature and active throttle reasons,
sampled beside a window through NVML (``libnvidia-ml.so.1``, the library
that ``nvidia-smi`` reads). It only reads: it locks no clock, sets no
power limit and changes no mode of the card.

``Sampler(device, period_s)`` starts a daemon thread that takes one
reading every ``period_s`` seconds, each stamped with
``time.perf_counter()``; ``close()`` stops it and waits for it.
``between(t0, t1)`` sums up the readings that lie inside ``[t0, t1]``.
Where there is no NVML (no NVIDIA driver, as on a CPU-only machine) or
the device is not a CUDA device, the sampler takes no reading and
``between`` returns None: it raises nothing.

NVML's calls release the interpreter lock (``ctypes``), and a reading
takes the lock for a few microseconds of Python every ``period_s``
seconds, so the thread that launches the kernels barely meets it.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import List, Optional, Tuple

_CLOCK_SM = 1  # nvmlClockType_t NVML_CLOCK_SM
_TEMPERATURE_GPU = 0  # nvmlTemperatureSensors_t NVML_TEMPERATURE_GPU
# bits of nvmlDeviceGetCurrentClocksEventReasons (ThrottleReasons before)
REASONS = {0x1: "gpu_idle", 0x2: "app_clocks", 0x4: "sw_power_cap", 0x8: "hw_slowdown",
           0x10: "sync_boost", 0x20: "sw_thermal", 0x40: "hw_thermal",
           0x80: "hw_power_brake", 0x100: "display_clocks"}

# (perf_counter, SM MHz, W, degrees C, reason bits); a field NVML did not give is None
Reading = Tuple[float, Optional[float], Optional[float], Optional[float], Optional[int]]


def _pci_bus_id(device) -> Optional[str]:
    """NVML's form of the device's PCI address, where torch gives it."""
    import torch

    p = torch.cuda.get_device_properties(device)
    try:
        return f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"
    except AttributeError:
        return None


class _Nvml:
    """A handle of one device and the four reads, or ``ok`` False."""

    def __init__(self, device):
        self.ok = False
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        self.lib = lib
        for name in ("nvmlInit_v2", "nvmlShutdown"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        if lib.nvmlInit_v2() != 0:
            return
        self.handle = ctypes.c_void_p()
        bus = _pci_bus_id(device)
        if bus is not None:
            f = lib.nvmlDeviceGetHandleByPciBusId_v2
            f.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
            rc = f(bus.encode(), ctypes.byref(self.handle))
        else:
            f = lib.nvmlDeviceGetHandleByIndex_v2
            f.argtypes = [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
            rc = f(device.index or 0, ctypes.byref(self.handle))
        f.restype = ctypes.c_int
        if rc != 0:
            lib.nvmlShutdown()
            return
        uint_p, ull_p = ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_ulonglong)
        self.clock = self._fn("nvmlDeviceGetClockInfo", [ctypes.c_void_p, ctypes.c_int, uint_p])
        self.power = self._fn("nvmlDeviceGetPowerUsage", [ctypes.c_void_p, uint_p])
        self.temp = self._fn("nvmlDeviceGetTemperature", [ctypes.c_void_p, ctypes.c_int, uint_p])
        self.reasons = (self._fn("nvmlDeviceGetCurrentClocksEventReasons", [ctypes.c_void_p, ull_p])
                        or self._fn("nvmlDeviceGetCurrentClocksThrottleReasons",
                                    [ctypes.c_void_p, ull_p]))
        self.ok = True

    def _fn(self, name, argtypes):
        try:
            f = getattr(self.lib, name)
        except AttributeError:  # an older or newer NVML without it
            return None
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    def read(self) -> Reading:
        t = time.perf_counter()
        u, r = ctypes.c_uint(), ctypes.c_ulonglong()
        mhz = float(u.value) if self.clock(self.handle, _CLOCK_SM, ctypes.byref(u)) == 0 else None
        watts = u.value / 1000.0 if self.power(self.handle, ctypes.byref(u)) == 0 else None
        temp = (float(u.value) if self.temp(self.handle, _TEMPERATURE_GPU, ctypes.byref(u)) == 0
                else None)
        bits = (int(r.value) if self.reasons is not None
                and self.reasons(self.handle, ctypes.byref(r)) == 0 else None)
        return t, mhz, watts, temp, bits

    def close(self):
        self.lib.nvmlShutdown()


class Sampler:
    def __init__(self, device, period_s: float = 0.5):
        self.period_s = float(period_s)
        self.readings: List[Reading] = []
        self._stop = threading.Event()
        self._thread = None
        self._nvml = _Nvml(device) if getattr(device, "type", None) == "cuda" else None
        if self._nvml is not None and self._nvml.ok:
            self._thread = threading.Thread(target=self._loop, name="port_bench.card",
                                            daemon=True)
            self._thread.start()

    def _loop(self):
        while True:
            self.readings.append(self._nvml.read())
            if self._stop.wait(self.period_s):
                return

    def close(self):
        """Stop the thread and wait for it (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._nvml.close()

    def between(self, t0: float, t1: float) -> Optional[dict]:
        """The readings inside ``[t0, t1]`` (perf_counter seconds), summed
        up: their count, the SM clock's mean, least and most, the mean
        power, the first and last temperature, and each active reason's
        share of the readings; None where none lies there."""
        rows = [r for r in self.readings if t0 <= r[0] <= t1]
        mhz = [r[1] for r in rows if r[1] is not None]
        if not mhz:
            return None
        watts = [r[2] for r in rows if r[2] is not None]
        temps = [r[3] for r in rows if r[3] is not None]
        bits = [r[4] for r in rows if r[4] is not None]
        reasons = {name: sum(1 for b in bits if b & bit) / len(bits)
                   for bit, name in REASONS.items() if any(b & bit for b in bits)}
        return {"readings": len(rows), "sm_clock_mhz": sum(mhz) / len(mhz),
                "sm_clock_mhz_min": min(mhz), "sm_clock_mhz_max": max(mhz),
                "power_w": sum(watts) / len(watts) if watts else None,
                "temp_c": [temps[0], temps[-1]] if temps else None, "reasons": reasons}
