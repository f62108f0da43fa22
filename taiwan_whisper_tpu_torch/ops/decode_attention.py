"""Decode-step attention: the CUDA kernels and their plain versions.

Replace taiwan_whisper_tpu/ops/decode_attention.py::cross_decode_attention
and self_decode_attention. Both kernels (csrc/decode_attention.cu) run one
block per (batch, head) over the time-minor K/V layout the JAX package
keeps, dequantize int8/fp8 storage in registers and return fp32. They are
bound by bytes: every decode step streams the whole cross K/V of every
layer. In the JAX package these kernels are an opt-in the TPU never took
(XLA already fused the dequant into its einsums); eager PyTorch has no such
fusion — the plain path materialises a bf16 copy of the whole cross K/V per
layer per step — so on the card the model always takes the kernels.

Numerical contract (the JAX model's einsum path): q arrives pre-scaled in
the compute dtype; scores and softmax in fp32; probabilities rounded to the
compute dtype; P V accumulated in fp32; fp32 output.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_P, _L, _I = _build.P, _build.L, _build.I
_SIG = {
    "twt_cross_attention": [_I] * 6 + [_P, _L, _L, _L] * 4 + [_P],
    "twt_self_attention": [_I] * 4 + [_P, _L, _L] * 3 + [_P, _L, _L, _L] * 2
    + [_P, _P, _P],
}
HEAD_DIM = 64
MAX_ROWS = 8
_CROSS_KV = {torch.bfloat16: (torch.bfloat16, torch.int8, torch.float8_e4m3fn),
             torch.float32: (torch.float32, torch.int8, torch.float8_e4m3fn)}


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, R, H, Dh] (pre-scaled) against time-minor k/v [B, H, Dh, T]."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bhdt->bhqt", q.float(), k.to(dtype).float())
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqt,bhdt->bqhd", probs.float(), v.to(dtype).float())


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of 1-8 query rows per (b, h): fp32 [B, R, H, Dh]."""
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v)
    _build.require_cuda(q, k, v)
    b, r, h, d = q.shape
    t = k.shape[-1]
    if d != HEAD_DIM or k.shape != (b, h, d, t) or v.shape != k.shape or not 1 <= r <= MAX_ROWS:
        raise ValueError(f"cross attention takes q [B,1..8,H,64], k/v [B,H,64,T]; got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in _CROSS_KV.get(q.dtype, ()):
        raise ValueError(f"no cross-attention kernel for q {q.dtype}, k/v {k.dtype}/{v.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q needs a contiguous head dim and k/v a contiguous time axis")
    out = torch.empty((b, r, h, d), device=q.device, dtype=torch.float32)
    lib = _build.load("decode_attention", _SIG)
    _build.check(lib.twt_cross_attention(
        _build.dtype_code(q), _build.dtype_code(k), b, h, r, t,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
        _build.stream_of(q)), "cross attention kernel")
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
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("self attention needs a contiguous last axis")
    if valid_from is not None:  # None reaches the kernel as a null pointer: no floor
        _build.require_cuda(q, valid_from)
        valid_from = valid_from.to(torch.int32).contiguous()
    out = torch.empty((b, h, d), device=q.device, dtype=torch.float32)
    lib = _build.load("decode_attention", _SIG)
    _build.check(lib.twt_self_attention(
        _build.dtype_code(q), b, h, index,
        q.data_ptr(), q.stride(0), q.stride(1),
        k_t.data_ptr(), k_t.stride(0), k_t.stride(1),
        v_t.data_ptr(), v_t.stride(0), v_t.stride(1),
        cache_k.data_ptr(), cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
        cache_v.data_ptr(), cache_v.stride(0), cache_v.stride(1), cache_v.stride(2),
        None if valid_from is None else valid_from.data_ptr(), out.data_ptr(),
        _build.stream_of(q)), "self attention kernel")
    self_attention.launches += 1
    return out


self_attention.launches = 0
