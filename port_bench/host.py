"""The CPU seconds of each thread of this process over a stretch of a
run, read from ``/proc/self/task`` before and after it (reading only):
each thread named by ``threading`` where Python started it, else by the
kernel's name for it (``pt_autograd_0``: autograd's device thread). A
thread that does the same work each step (the port's prefetch worker)
tells by its CPU seconds how fast the host ran.

``snapshot()`` takes the readings; ``delta(a, b)`` is what changed from
``a`` to ``b``. Without ``/proc`` there are no threads: nothing raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _threads() -> Dict[int, list]:
    """``{native id: [name, CPU seconds]}`` of this process's threads."""
    named = {t.native_id: t.name for t in threading.enumerate() if t.native_id is not None}
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat", encoding="ascii") as f:
                st = f.read()
        except OSError:  # a thread that ended meanwhile
            continue
        comm = st[st.index("(") + 1:st.rindex(")")]
        rest = st[st.rindex(")") + 2:].split()
        cpu = (int(rest[11]) + int(rest[12])) / _TICK  # utime + stime
        out[int(tid)] = [named.get(int(tid), comm), cpu]
    return out


def snapshot() -> dict:
    return {"t": time.perf_counter(), "threads": _threads()}


def delta(a: dict, b: dict) -> dict:
    """From snapshot ``a`` to ``b``: the wall, and the CPU seconds of each
    thread (by name; threads of one name summed)."""
    out = {"wall_s": b["t"] - a["t"], "threads": {}}
    for tid, (name, cpu) in b["threads"].items():
        used = cpu - a["threads"].get(tid, [name, 0.0])[1]
        out["threads"][name] = round(out["threads"].get(name, 0.0) + used, 3)
    return out
