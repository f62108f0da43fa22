"""Percent of its bound (``roofline/cross_attn.py``, from shapes) that the
device time of every kernel launched inside
``models/whisper.py::_cross_attention`` reached, over the traced stretches."""

from port_bench.roofline import cross_attn
from port_bench.trace import range_roofline


def install(ctx):
    cross_attn.install(ctx)


def read(rec):
    return range_roofline(rec["trace"], "cross_attn")
