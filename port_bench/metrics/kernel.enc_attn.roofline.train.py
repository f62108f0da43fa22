"""Percent of its bound (``roofline/enc_attn.py``, from shapes) that the
device time of every kernel launched inside ``encoder_attention``, as
``models/whisper.py::_encoder_layer`` calls it, reached over the traced
stretches."""

from port_bench.roofline import enc_attn
from port_bench.trace import range_roofline


def install(ctx):
    enc_attn.install(ctx)


def read(rec):
    return range_roofline(rec["trace"], "enc_attn")
