"""Cross attention of a decode step or prefill, from shapes (frozen from
``chip_smoke.py::cross_bound`` at 2a03127): K and V read once at their
stored width (packed int4: half a byte a position), q read, the fp32
output written; 4 operations per K/V position, head dimension and query
row, at q's type."""

from . import bound_s


def bound(q_shape, beams: int, kv_shape, kv_elem_bytes: float, q_elem_bytes: int) -> float:
    """q [B*beams, Sq, H, Dh] against K/V [B, H, Dh, T] (logical T)."""
    bk, sq, h, d = q_shape
    b, _, _, t = kv_shape
    rows = sq * beams
    n_bytes = 2 * b * h * d * t * kv_elem_bytes + bk * sq * h * d * q_elem_bytes \
        + bk * sq * h * d * 4
    return bound_s(n_bytes, 4 * b * h * rows * t * d, "bf16" if q_elem_bytes == 2 else "fp32")


def install(ctx, range_name: str = "cross_attn"):
    """Wrap ``models.whisper._cross_attention`` (the model-level call that
    attends one layer's queries to the cross K/V, whatever implements it):
    while a stretch is traced or a CUDA graph capture is recorded, each
    call runs in a ``bench:cross_attn`` range and adds its bound to the
    stretch, or to the capture (added to a take once per replay)."""
    import torch
    from taiwan_whisper_tpu_torch.models import whisper as M

    def make(orig):
        def wrapped(q, cross_slice, dtype, beams=1, int8_dots=False):
            s = ctx.active_stretch()
            if s is None:
                return orig(q, cross_slice, dtype, beams, int8_dots)
            kq, t = cross_slice[0], cross_slice[4]
            packed = kq.dtype == torch.uint8
            t = t or kq.shape[-1] * (2 if packed else 1)
            elem = 0.5 if packed else kq.element_size()
            q_elem = 4 if (int8_dots or kq.dtype == torch.float32) else 2
            s.acc[range_name] += bound(tuple(q.shape), beams, (kq.shape[0], kq.shape[1],
                                                              kq.shape[2], t), elem, q_elem)
            with torch.profiler.record_function(f"bench:{range_name}"):
                return orig(q, cross_slice, dtype, beams, int8_dots)
        return wrapped

    ctx.patch(M, "_cross_attention", make)
