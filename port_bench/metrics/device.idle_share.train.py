"""Share of the traced train steps' wall in which no operation ran on the
device (1 - the union of kernel, copy and set intervals over the wall),
in percent."""

from port_bench.trace import idle_share


def read(rec):
    return idle_share((rec["trace"] or {}).get("step"))
