"""Percent of its bound (``roofline/dec_attn.py``, from shapes) that the
device time of every kernel launched inside ``decoder_attention``, as
``models/whisper.py::_decoder_train_layer`` calls it, reached over the
traced stretches. None where the port has no such call."""

from port_bench.roofline import dec_attn
from port_bench.trace import range_roofline


def install(ctx):
    dec_attn.install(ctx)


def read(rec):
    return range_roofline(rec["trace"], "dec_attn")
