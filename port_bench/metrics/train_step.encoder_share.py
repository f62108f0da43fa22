"""Share of the traced train steps' busy device time taken by the
operations launched inside the port's ``tw:train.encode`` range (the
frozen encoder's forward; ``port_bench/spans.py``), in percent."""

from port_bench import spans


def install(ctx):
    spans.install(ctx)


def read(rec):
    return spans.device_share(rec["trace"], "step", "train.encode")
