"""The teacher-forcing decoder's attention, from shapes: q, k and v read
once and the output written once; QK^T and PV, 4 operations per query, key
and head dimension that the mask keeps (cross-attention every key; causal
self-attention S(S+1)/2 query-key pairs), at the inputs' type. The kernel's
work on the masked half of its diagonal tiles is not counted."""

from . import bound_s


def bound(q_shape, k_shape, causal: bool, elem_bytes: int) -> float:
    """q of ``q_shape`` [B, Sq, H, Dh], k and v of ``k_shape`` [B, Sk, H, Dh]."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    n_bytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * elem_bytes
    return bound_s(n_bytes, 4 * b * h * d * pairs, "bf16" if elem_bytes == 2 else "fp32")


def install(ctx, range_name: str = "dec_attn"):
    """Wrap ``decoder_attention`` as ``models/whisper.py::_decoder_train_layer``
    calls it: while a stretch is traced or a CUDA graph capture is
    recorded, each call runs in a ``bench:dec_attn`` range and adds its
    bound to the stretch, or to the capture (added to a take once per
    replay). A port
    without ``decoder_attention`` is left as it is (the metric reads
    nothing there)."""
    import torch
    from taiwan_whisper_tpu_torch.models import whisper as M

    if not hasattr(M, "decoder_attention"):
        return

    def make(orig):
        def wrapped(q, k, v, causal):
            s = ctx.active_stretch()
            if s is None:
                return orig(q, k, v, causal=causal)
            s.acc[range_name] += bound(tuple(q.shape), tuple(k.shape), causal,
                                       q.element_size())
            with torch.profiler.record_function(f"bench:{range_name}"):
                return orig(q, k, v, causal=causal)
        return wrapped

    ctx.patch(M, "decoder_attention", make)
