"""Decode-step attention: the CUDA kernels and their plain versions.

Replace taiwan_whisper_tpu/ops/decode_attention.py::cross_decode_attention
and self_decode_attention. Both kernels (csrc/decode_attention.cu) read the
time-minor K/V layout the JAX package keeps, dequantize int8/fp8 storage in
registers and return fp32. They are bound by bytes: every decode step
streams the whole cross K/V of every layer. One (batch, head) is a
thread-block cluster that splits the positions (``decode_split``); each
block pulls its rows into shared memory with 16-byte copies, which need every
row to start on 16 bytes, so the model stores these tensors with the last
axis padded (``time_minor_zeros``). In the JAX package these kernels are an
opt-in the TPU never took (XLA already fused the dequant into its einsums);
eager PyTorch has no such fusion — the plain path materialises a bf16 copy
of the whole cross K/V per layer per step — so on the card the model always
takes the kernels.

Numerical contract (the JAX model's einsum path): q arrives pre-scaled in
the compute dtype; scores and softmax in fp32; probabilities normalised,
then rounded to the compute dtype; P V accumulated in fp32; fp32 output.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build

_P, _L, _I = _build.P, _build.L, _build.I
_SIG = {
    "twt_cross_attention": [_I] * 8 + [_P, _L, _L, _L] * 4 + [_P],
    "twt_self_attention": [_I] * 6 + [_P, _L, _L] * 3 + [_P, _L, _L, _L] * 2
    + [_P, _P, _P],
}
HEAD_DIM = 64
MAX_ROWS = 8  # query rows the cross kernel takes in one tile
MAX_QUERY_ROWS = MAX_ROWS * 448  # rows per call: tiles of 8 on the kernel's grid
_CROSS_KV = {torch.bfloat16: (torch.bfloat16, torch.int8, torch.float8_e4m3fn),
             torch.float32: (torch.float32, torch.int8, torch.float8_e4m3fn)}

ROW_ALIGN = 128  # bytes: where each row of a padded time-minor tensor starts
CLUSTERS = (1, 2, 4, 8)  # blocks per (batch, head) the kernels take
SPAN_ALIGN = 16  # positions: a block's span starts on 16 bytes for every storage type
# bytes of each K/V row one block stages, by default: the smallest cluster
# whose span fits (on the card: PERF.md, the decode-attention split A/B).
# Cross: 2 blocks for fp8 rows of 1500. Self: one block up to 208 bf16
# positions, whose one staged tile still lets a step's 640 blocks (large-v2,
# batch 32) run at once.
CROSS_SPAN_BYTES = 768
SELF_SPAN_BYTES = 416


def padded_length(t: int, elem_size: int) -> int:
    """Positions of storage a row of ``t`` positions takes so that rows
    start on ``ROW_ALIGN`` bytes."""
    return -(-t * elem_size // ROW_ALIGN) * ROW_ALIGN // elem_size


def time_minor_zeros(shape: Sequence[int], dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` whose last (time) axis is stored padded to
    ``padded_length``: a view of the logical length, so every row starts on
    ``ROW_ALIGN`` bytes, as the kernels' 16-byte copies need."""
    *lead, t = shape
    elem = torch.empty((), dtype=dtype).element_size()
    full = torch.zeros((*lead, padded_length(t, elem)), dtype=dtype, device=device)
    return full[..., :t]


def time_minor_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into padded time-minor storage."""
    out = time_minor_zeros(x.shape, x.dtype, x.device)
    out.copy_(x)
    return out


def decode_split(t: int, elem_size: int, cluster: Optional[int] = None,
                 span_bytes: int = CROSS_SPAN_BYTES) -> Tuple[int, int]:
    """(C, span): the cluster size and the positions each of its blocks
    owns for rows of ``t`` positions of ``elem_size`` bytes. Block c takes
    [c * span, (c + 1) * span); spans are multiples of ``SPAN_ALIGN``.
    Without ``cluster``: the smallest C in ``CLUSTERS`` whose span is at
    most ``span_bytes`` long, else the largest."""
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"the decode kernels take clusters of {CLUSTERS} blocks, not {cluster}")
    return _split(t, elem_size, cluster, span_bytes)


@functools.lru_cache(maxsize=None)
def _split(t, elem_size, cluster, span_bytes):
    def span_of(c):
        return max(SPAN_ALIGN, -(-t // (c * SPAN_ALIGN)) * SPAN_ALIGN)

    if cluster is None:
        cluster = next((c for c in CLUSTERS if span_of(c) * elem_size <= span_bytes),
                       CLUSTERS[-1])
    return cluster, span_of(cluster)


def _check_rows(x: torch.Tensor, strides, what: str):
    """Every row of the 4-D time-minor ``x`` (``strides`` its strides)
    starts on 16 bytes, as the kernels' 16-byte copies need."""
    elem = x.element_size()
    if (x.data_ptr() | strides[0] * elem | strides[1] * elem | strides[2] * elem) % 16:
        raise ValueError(
            f"{what} reads its K/V rows with 16-byte copies: every row must start on "
            f"16 bytes (got strides {tuple(strides)} of {elem}-byte elements); store the "
            f"tensor with ops.decode_attention.time_minor_zeros or time_minor_copy")


_bound = {}


def _kernel(name: str):
    """The C entry ``name``, bound once: no per-call library lookup."""
    fn = _bound.get(name)
    if fn is None:
        fn = _bound[name] = getattr(_build.load("decode_attention", _SIG), name)
    return fn


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, R, H, Dh] (pre-scaled) against time-minor k/v [B, H, Dh, T]."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bhdt->bhqt", q.float(), k.to(dtype).float())
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqt,bhdt->bqhd", probs.float(), v.to(dtype).float())


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of R query rows per (b, h), 1 <= R <= ``MAX_QUERY_ROWS``
    (the kernel runs them in tiles of ``MAX_ROWS``): fp32 [B, R, H, Dh]."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v)
    _build.require_cuda(q, k, v)
    b, r, h, d = q.shape
    t = k.shape[-1]
    if d != HEAD_DIM or k.shape != (b, h, d, t) or v.shape != k.shape \
            or not 1 <= r <= MAX_QUERY_ROWS or t < 1:
        raise ValueError(f"cross attention takes q [B,1..{MAX_QUERY_ROWS},H,64], k/v [B,H,64,T]; "
                         f"got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in _CROSS_KV.get(q.dtype, ()):
        raise ValueError(f"no cross-attention kernel for q {q.dtype}, k/v {k.dtype}/{v.dtype}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("q needs a contiguous head dim and k/v a contiguous time axis")
    _check_rows(k, ks, "cross attention")
    _check_rows(v, vs, "cross attention")
    c, span = decode_split(t, k.element_size())
    out = torch.empty((b, r, h, d), device=q.device, dtype=torch.float32)
    _build.check(_kernel("twt_cross_attention")(
        _build.dtype_code(q), _build.dtype_code(k), b, h, r, t, c, span,
        q.data_ptr(), *qs[:3], k.data_ptr(), *ks[:3], v.data_ptr(), *vs[:3],
        out.data_ptr(), h * r * d, h * d, d, _build.stream_of(q)), "cross attention kernel")
    cross_attention.launches += 1
    return out


cross_attention.launches = 0


def self_attention_plain(q, cache_k, cache_v, k_t, v_t, index: int,
                         valid_from: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k_t/v_t [B, H, Dh] (q pre-scaled) against the cache [B, H, Dh, S],
    positions valid_from <= pos < index, plus the current token."""
    dtype = q.dtype
    s = cache_k.shape[-1]
    logits = torch.einsum("bhd,bhds->bhs", q.float(), cache_k.float())
    pos = torch.arange(s, device=q.device)
    keep = pos[None, None] < index
    if valid_from is not None:
        keep = keep & (pos[None, None] >= valid_from[:, None, None])
    logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    cur = (q.float() * k_t.to(dtype).float()).sum(-1)
    probs = torch.softmax(torch.cat([logits, cur[..., None]], dim=-1), dim=-1).to(dtype)
    out = torch.einsum("bhs,bhds->bhd", probs[..., :s].float(), cache_v.float())
    return out + probs[..., s:].float() * v_t.float()


def self_attention(q, cache_k, cache_v, k_t, v_t, index: int,
                   valid_from: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token self-attention over the cache + current token: fp32 [B, H, Dh]."""
    if q.device.type == "cpu":
        return self_attention_plain(q, cache_k, cache_v, k_t, v_t, index, valid_from)
    _build.require_cuda(q, cache_k, cache_v, k_t, v_t)
    b, h, d = q.shape
    s = cache_k.shape[-1]
    if d != HEAD_DIM or cache_k.shape != (b, h, d, s) or cache_v.shape != cache_k.shape \
            or k_t.shape != q.shape or v_t.shape != q.shape or not 0 <= index <= s:
        raise ValueError(f"self attention takes q/k_t/v_t [B,H,64], cache [B,H,64,S], "
                         f"0 <= index <= S; got {tuple(q.shape)} {tuple(cache_k.shape)} {index}")
    tensors = (q, k_t, v_t, cache_k, cache_v)
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("self attention takes one dtype, bf16 or fp32, for q, k_t, v_t and the cache")
    qs, kts, vts, cks, cvs = (t.stride() for t in tensors)
    if qs[2] != 1 or kts[2] != 1 or vts[2] != 1 or cks[3] != 1 or cvs[3] != 1:
        raise ValueError("self attention needs a contiguous last axis")
    _check_rows(cache_k, cks, "self attention")
    _check_rows(cache_v, cvs, "self attention")
    if valid_from is not None:  # None reaches the kernel as a null pointer: no floor
        _build.require_cuda(q, valid_from)
        valid_from = valid_from.to(torch.int32).contiguous()
    c, span = decode_split(index, q.element_size(), span_bytes=SELF_SPAN_BYTES)
    out = torch.empty((b, h, d), device=q.device, dtype=torch.float32)
    _build.check(_kernel("twt_self_attention")(
        _build.dtype_code(q), b, h, index, c, span,
        q.data_ptr(), *qs[:2], k_t.data_ptr(), *kts[:2], v_t.data_ptr(), *vts[:2],
        cache_k.data_ptr(), *cks[:3], cache_v.data_ptr(), *cvs[:3],
        None if valid_from is None else valid_from.data_ptr(), out.data_ptr(),
        _build.stream_of(q)), "self attention kernel")
    self_attention.launches += 1
    return out


self_attention.launches = 0
