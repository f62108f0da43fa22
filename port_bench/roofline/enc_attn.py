"""Encoder self attention, from shapes: q, k and v read once and the
output written once; QK^T and PV, 4 operations per query, key and head
dimension, at the inputs' type."""

from . import bound_s


def bound(shape, elem_bytes: int) -> float:
    """q, k, v of ``shape`` [B, S, H, Dh]."""
    b, s, h, d = shape
    return bound_s(4 * b * s * h * d * elem_bytes, 4 * b * h * s * s * d,
                   "bf16" if elem_bytes == 2 else "fp32")


def install(ctx, range_name: str = "enc_attn"):
    """Wrap ``encoder_attention`` as ``models/whisper.py::_encoder_layer``
    calls it: while a stretch is traced or a CUDA graph capture is
    recorded, each call runs in a ``bench:enc_attn`` range and adds its
    bound to the stretch, or to the capture (added to a take once per
    replay)."""
    import torch
    from taiwan_whisper_tpu_torch.models import whisper as M

    def make(orig):
        def wrapped(q, k, v, *args, **kwargs):
            s = ctx.active_stretch()
            if s is None:
                return orig(q, k, v, *args, **kwargs)
            s.acc[range_name] += bound(tuple(q.shape), q.element_size())
            with torch.profiler.record_function(f"bench:{range_name}"):
                return orig(q, k, v, *args, **kwargs)
        return wrapped

    ctx.patch(M, "encoder_attention", make)
