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

Cross K/V storage: fp32 / bf16 / int8 / fp8, or int4 packed two positions
a byte (``pack_int4``: position 2j in the low nibble; PyTorch has no int4
dtype, so the storage is uint8 and the wrappers take the logical length
``t``). ``cross_attention_int8_dots`` is the JAX model's "8x8" route
(``taiwan_whisper_tpu/models/whisper.py:506-526``) as a variant of the
same kernel: fp32 q quantized to int8 per row, int8 x int8 scores, the
fp32 softmax, probabilities quantized to int8, int8 x int8 P V.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build

_P, _L, _I = _build.P, _build.L, _build.I
_SIG = {
    "twt_cross_attention": [_I] * 8 + [_P, _L, _L, _L] * 4 + [_P],
    "twt_cross_attention_int8_dots": [_I] * 6 + [_P, _L, _L, _L] * 4 + [_P],
    "twt_self_attention": [_I] * 6 + [_P, _L, _L] * 3 + [_P, _L, _L, _L] * 2
    + [_P, _P, _P],
}
HEAD_DIM = 64
MAX_ROWS = 8  # query rows the cross kernel takes in one tile
MAX_QUERY_ROWS = MAX_ROWS * 448  # rows per call: tiles of 8 on the kernel's grid
# the K/V storage each q dtype takes; uint8 is int4 packed two positions a byte
_CROSS_KV = {torch.bfloat16: (torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.uint8),
             torch.float32: (torch.float32, torch.int8, torch.float8_e4m3fn, torch.uint8)}
_INT4_CODE = 4  # the kernel's dtype code of packed int4 storage

ROW_ALIGN = 128  # bytes: where each row of a padded time-minor tensor starts
CLUSTERS = (1, 2, 4, 8)  # blocks per (batch, head) the kernels take
SPAN_ALIGN = 16  # positions: a block's span starts on 16 bytes for every storage type
SPAN_ALIGN4 = 32  # positions of packed int4 (half a byte each) in 16 bytes
# bytes of each K/V row one block stages, by default: the smallest cluster
# whose span fits (on the card: PERF.md, the decode-attention split A/B).
# Cross: 2 blocks for fp8 rows of 1500. Self: one block up to 208 bf16
# positions, whose one staged tile still lets a step's 640 blocks (large-v2,
# batch 32) run at once.
CROSS_SPAN_BYTES = 768
SELF_SPAN_BYTES = 416


def span_align(elem_size: float) -> int:
    """Positions a span is a multiple of: 16 bytes of packed int4
    (``elem_size`` 0.5), 16 positions for the wider types."""
    return SPAN_ALIGN4 if elem_size < 1 else SPAN_ALIGN


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] along the last axis [..., T] -> uint8
    [..., ceil(T / 2)]: position 2j in the low nibble of byte j, 2j + 1 in
    the high nibble, two's complement; an odd T packs a zero high nibble."""
    if x.shape[-1] % 2:
        x = torch.nn.functional.pad(x, (0, 1))
    x = x.to(torch.int16) & 0xF
    return (x[..., 0::2] | (x[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor, t: int) -> torch.Tensor:
    """uint8 [..., ceil(t / 2)] of ``pack_int4`` -> int8 [..., t]."""
    n = p.to(torch.int16)
    nib = torch.stack([n & 0xF, n >> 4], dim=-1).flatten(-2)[..., :t]
    return ((nib ^ 8) - 8).to(torch.int8)


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


def decode_split(t: int, elem_size: float, cluster: Optional[int] = None,
                 span_bytes: int = CROSS_SPAN_BYTES) -> Tuple[int, int]:
    """(C, span): the cluster size and the positions each of its blocks
    owns for rows of ``t`` positions of ``elem_size`` bytes (0.5 for packed
    int4). Block c takes [c * span, (c + 1) * span); spans are multiples of
    ``span_align(elem_size)``. Without ``cluster``: the smallest C in
    ``CLUSTERS`` whose span is at most ``span_bytes`` long, else the
    largest."""
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"the decode kernels take clusters of {CLUSTERS} blocks, not {cluster}")
    return _split(t, elem_size, cluster, span_bytes)


@functools.lru_cache(maxsize=None)
def _split(t, elem_size, cluster, span_bytes):
    align = span_align(elem_size)

    def span_of(c):
        return max(align, -(-t // (c * align)) * align)

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


def _int4_length(k: torch.Tensor, t: Optional[int]) -> Optional[int]:
    """The logical length packed int4 K/V must be given: its storage holds
    ceil(t / 2) bytes a row, so an odd t cannot be read off the shape."""
    if k.dtype == torch.uint8 and t is None:
        raise ValueError("packed int4 K/V needs its logical length t")
    return t


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          t: Optional[int] = None) -> torch.Tensor:
    """q [B, R, H, Dh] (pre-scaled) against time-minor k/v [B, H, Dh, T]
    (packed int4: uint8 [B, H, Dh, ceil(t / 2)], unpacked first; ``t``
    required)."""
    if k.dtype == torch.uint8:
        t = _int4_length(k, t)
        k, v = unpack_int4(k, t), unpack_int4(v, t)
    dtype = q.dtype
    logits = torch.einsum("bqhd,bhdt->bhqt", q.float(), k.to(dtype).float())
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqt,bhdt->bqhd", probs.float(), v.to(dtype).float())


def _check_cross(q, k, v, t: int):
    """The shapes, dtypes and strides the cross kernels take; returns the
    kernel's dtype code of the K/V storage."""
    _build.require_cuda(q, k, v)
    b, r, h, d = q.shape
    width = -(-t // 2) if k.dtype == torch.uint8 else t
    if d != HEAD_DIM or k.shape != (b, h, d, width) or v.shape != k.shape \
            or not 1 <= r <= MAX_QUERY_ROWS or t < 1:
        raise ValueError(f"cross attention takes q [B,1..{MAX_QUERY_ROWS},H,64], k/v [B,H,64,T] "
                         f"(packed int4: [B,H,64,ceil(T/2)]); got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}, T {t}")
    if k.dtype != v.dtype or k.dtype not in _CROSS_KV.get(q.dtype, ()):
        raise ValueError(f"no cross-attention kernel for q {q.dtype}, k/v {k.dtype}/{v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q needs a contiguous head dim and k/v a contiguous time axis")
    _check_rows(k, k.stride(), "cross attention")
    _check_rows(v, v.stride(), "cross attention")
    return _INT4_CODE if k.dtype == torch.uint8 else _build.dtype_code(k)


def _cross_launch(q, k, v, t: int, int8_dots: bool) -> torch.Tensor:
    code = _check_cross(q, k, v, t)
    b, r, h, d = q.shape
    c, span = decode_split(t, 0.5 if code == _INT4_CODE else k.element_size())
    out = torch.empty((b, r, h, d), device=q.device, dtype=torch.float32)
    args = (b, h, r, t, c, span, q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], out.data_ptr(), h * r * d, h * d, d,
            _build.stream_of(q))
    if int8_dots:
        _build.check(_kernel("twt_cross_attention_int8_dots")(*args),
                     "cross attention kernel (int8 dots)")
    else:
        _build.check(_kernel("twt_cross_attention")(_build.dtype_code(q), code, *args),
                     "cross attention kernel")
    cross_attention.launches += 1
    cross_attention.launches_by_rows[r] = cross_attention.launches_by_rows.get(r, 0) + 1
    return out


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    t: Optional[int] = None) -> torch.Tensor:
    """Cross-attention of R query rows per (b, h), 1 <= R <= ``MAX_QUERY_ROWS``
    (the kernel runs them in tiles of ``MAX_ROWS``): fp32 [B, R, H, Dh].
    ``t``: the logical length, required for packed int4 K/V (default: the
    storage's length)."""
    t = _int4_length(k, t) if k.dtype == torch.uint8 else (k.shape[-1] if t is None else t)
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, t)
    return _cross_launch(q, k, v, t, int8_dots=False)


cross_attention.launches = 0
cross_attention.launches_by_rows = {}  # query rows R -> launches


def quantize_rows_int8(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The "8x8" route's q quantization, per (b, row, h) over Dh, as the JAX
    model does it: (int8 q8, fp32 qmax) with qmax = max |q| + 1e-12 and
    q8 = clip(round(q / qmax * 127)), rounded half to even."""
    qmax = q.abs().amax(dim=-1, keepdim=True) + 1e-12
    return torch.clamp(torch.round(q / qmax * 127.0), -127, 127).to(torch.int8), qmax


def cross_attention_int8_dots_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """The JAX model's "8x8" cross attention before the V scale, in torch:
    fp32 q [B, R, H, Dh] (1/sqrt(d) and the K scale folded in) against int8
    time-minor k/v [B, H, Dh, T]. The int32 dot products are taken exactly
    in fp64 (|sum| < 2^53) and rounded to fp32 as an int32 -> fp32 cast
    rounds them."""
    q8, qmax = quantize_rows_int8(q.float())
    logits = (torch.einsum("bqhd,bhdt->bhqt", q8.double(), k.double()).float()
              * (qmax / 127.0).permute(0, 2, 1, 3))
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True) + 1e-12
    p8 = torch.round(probs / pmax * 127.0)
    att = torch.einsum("bhqt,bhdt->bqhd", p8.double(), v.double()).float()
    return att * (pmax / 127.0).permute(0, 2, 1, 3)


def cross_attention_int8_dots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The "8x8" variant of the cross kernel: fp32 q [B, R, H, Dh] over int8
    K/V [B, H, Dh, T] with int8 x int8 dots; fp32 [B, R, H, Dh] before the V
    scale. Counts in ``cross_attention.launches``: it is the same kernel."""
    if q.device.type == "cpu":
        return cross_attention_int8_dots_plain(q, k, v)
    if q.dtype != torch.float32 or k.dtype != torch.int8:
        raise ValueError(f"the int8-dots cross kernel takes fp32 q and int8 K/V, got "
                         f"{q.dtype}, {k.dtype}")
    return _cross_launch(q, k, v, k.shape[-1], int8_dots=True)




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
