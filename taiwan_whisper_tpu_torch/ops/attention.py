"""Encoder self-attention: the CUDA flash kernel and the plain version.

Replaces taiwan_whisper_tpu/ops/attention.py::encoder_attention and its
flash route (encoder_attention_flash). The kernel (csrc/encoder_attention.cu)
is a flash-attention forward: bf16 mma.sync tensor-core products with fp32
online softmax in registers, 64-key tiles through shared memory, the
ragged last tile masked in the kernel. It is bound by operations (368.6
GFLOP per large-v2 batch of 32). An fp32 SIMT variant serves the fp32
policy. q/k/v are [B, S, H, Dh] and read through their strides.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_P, _L, _I = _build.P, _build.L, _build.I
_SIG = {"twt_encoder_attention": [_I, _I, _I, _I] + [_P, _L, _L, _L] * 4
        + [_build.F, _P]}
HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over [B, S, H, Dh] (the JAX model's
    ``_attention``): scores and softmax in fp32, probabilities and output in
    q's dtype. ``mask`` (bool, broadcastable to [B, H, Sq, Sk]) keeps True."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal MHA, [B, S, H, Dh] -> [B, S, H, Dh] in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _build.require_cuda(q, k, v)
    b, s, h, d = q.shape
    if d != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder attention takes equal [B,S,H,64] q/k/v, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"encoder attention takes bf16 or fp32 q/k/v, got {q.dtype}")
    for t in (q, k, v):
        # bf16 tiles are read as 16-byte vectors
        if t.stride(-1) != 1 or any(x % 8 for x in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"q/k/v need a contiguous head dim and 16-byte aligned "
                             f"rows, got strides {t.stride()}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("encoder_attention", _SIG)
    args = []
    for t in (q, k, v, out):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    _build.check(lib.twt_encoder_attention(
        _build.dtype_code(q), b, s, h, *args, d ** -0.5, _build.stream_of(q)),
        "encoder attention kernel")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
