"""Host kernel-launch calls per decode step over the steady steps of the
traced loop stretch (calls between the starts of consecutive
``decode_step`` ranges)."""

from port_bench.trace import launches_per_step


def read(rec):
    return launches_per_step({"loop": (rec["trace"] or {}).get("loop")})
