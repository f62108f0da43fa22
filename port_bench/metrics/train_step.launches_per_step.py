"""Host kernel-launch calls per train step in the traced stretch (calls
between the starts of consecutive steps)."""

from port_bench.trace import launches_per_step


def read(rec):
    return launches_per_step({"step": (rec["trace"] or {}).get("step")}, skip=0)
