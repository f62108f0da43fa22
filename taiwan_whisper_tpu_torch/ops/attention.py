"""Full-sequence attention: the CUDA flash kernels and the plain version,
for the encoder's self-attention and the teacher-forcing decoder's.

Replaces taiwan_whisper_tpu/ops/attention.py::encoder_attention and its
flash route, encoder_attention_flash, forward and backward (its custom VJP).
``decoder_attention`` replaces no Pallas kernel: it replaces the einsum
attention that the JAX model's ``_attention`` leaves to XLA in
``decode_train`` (causal self-attention over the labels, cross-attention
over the encoder's positions), where the decoder runs without a gradient
(the frozen teacher of distillation, evaluation losses).

* Forward (csrc/encoder_attention.cu): FlashAttention-3's design on
  Hopper: a producer warp TMA-loads q once and K/V tiles of 128 keys into
  a ring of shared-memory stages; two consumer warpgroups run q K^T and
  P V as wgmma (P from registers, V through the descriptor's transpose
  bit) with the online softmax in fp32 registers. Bound by operations
  (368.6 GFLOP per large-v2 encoder batch of 32; ~4.05 TFLOP of teacher
  decoder attention per distillation step at batch 32 and 448 tokens).
  The query and key lengths may differ (cross-attention: 448 against
  1500); the causal instantiation walks only the key tiles at or below
  each query tile's diagonal. It optionally writes the per-row
  log-sum-exp (LSE) the backward needs.
* Backward (csrc/encoder_attention_bwd.cu): without atomics, so gradients
  are deterministic: D = rowsum(dO * O), then a dK/dV kernel per 128-key
  tile (q, dO, LSE and D streamed; every product transposed so P^T and
  dS^T feed wgmma from registers) and a dQ kernel per 128-query tile (K/V
  streamed), each recomputing P from q, k and the LSE.

The bf16 kernels read q/k/v/dO through TMA tensor maps encoded per call
from the parameters ``tma_map_params`` computes here. The encoder's have
fp32 SIMT variants for the fp32 policy; the decoder's route is bf16 only.
q/k/v are [B, S, H, Dh] and read through their strides.

``encoder_attention`` launches the forward with no LSE (a null pointer)
when no gradient is wanted (inference, the frozen encoder); when one is,
it goes through ``EncoderAttention``, an autograd function whose forward
writes the LSE and whose backward is the backward kernel. On CPU tensors
it is the plain version under autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_P, _L, _I = _build.P, _build.L, _build.I
_SIG = {"twt_encoder_attention": [_I, _I, _I, _I] + [_P, _L, _L, _L] * 4
        + [_P, _P, _build.F, _P],
        "twt_decoder_attention": [_I, _I, _I, _I, _P, _P, _P, _P, _L, _L, _L, _P, _build.F,
                                  _I, _P]}
_SIG_BWD = {"twt_encoder_attention_bwd": [_I, _I, _I, _I] + [_P, _L, _L, _L] * 5
            + [_P, _P] + [_P, _L, _L, _L] * 3 + [_P, _build.F, _P]}
HEAD_DIM = 64
# rows of every tile the bf16 kernels load through a tensor map: the
# forward's q and K/V tiles and the backward's streamed and resident tiles
# (FWD_BQ, FWD_BK and BT in csrc/, which check the box against them)
TMA_BOX_ROWS = 128


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


def lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row log-sum-exp of the scaled fp32 scores, [B, H, S]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    return torch.logsumexp(logits, dim=-1)


def attention_backward_plain(q, k, v, dout) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``attention_plain`` by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_plain(*leaves)
        return torch.autograd.grad(out, leaves, dout)


def tma_map_params(t: torch.Tensor, rows: int = TMA_BOX_ROWS) -> dict:
    """The TMA tensor map of a [B, S, H, 64] bf16 tensor, as the bf16
    kernels encode it (csrc/hopper_attention.cuh::make_map): dims (d, h, s,
    b) innermost first, the byte strides of h, s and b, a box of ``rows``
    positions of one head, 128-byte swizzle (one 64-wide bf16 row is
    exactly the swizzle atom). TMA needs the base and every stride on 16
    bytes; raises otherwise."""
    b, s, h, d = t.shape
    size = t.element_size()
    if d * size != 128 or t.stride(-1) != 1:
        raise ValueError(f"a tensor map row is 64 contiguous bf16 (128 bytes), got shape "
                         f"{tuple(t.shape)} of {t.dtype}, strides {t.stride()}")
    strides = tuple(x * size for x in (t.stride(2), t.stride(1), t.stride(0)))
    if any(x % 16 for x in strides) or t.data_ptr() % 16:
        raise ValueError(f"TMA needs 16-byte aligned rows: byte strides (h, s, b) {strides}, "
                         f"base {t.data_ptr() % 16} bytes past a multiple of 16")
    if not 0 < rows <= 256:
        raise ValueError(f"a TMA box spans 1..256 rows, got {rows}")
    return {"dims": (d, h, s, b), "strides_bytes": strides, "box": (d, 1, rows, 1),
            "swizzle_bytes": 128}


def tma_map_words(*tensors: torch.Tensor):
    """What the C entries take for the tensor maps of ``tensors``: for bf16,
    a C array of twelve int64 words per tensor (hopper::MapParams),
    ``tma_map_params``' dims, strides, box and swizzle in that order; None
    for fp32, whose kernels read through plain pointers."""
    if tensors[0].dtype != torch.bfloat16:
        return None
    words = []
    for t in tensors:
        p = tma_map_params(t)
        words += [*p["dims"], *p["strides_bytes"], *p["box"], p["swizzle_bytes"]]
    return (ctypes.c_longlong * len(words))(*words)


def _check(*tensors):
    b, s, h, d = tensors[0].shape
    if d != HEAD_DIM or any(t.shape != tensors[0].shape for t in tensors):
        raise ValueError(f"encoder attention takes equal [B,S,H,64] tensors, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors) or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"encoder attention takes bf16 or fp32 tensors, got "
                         f"{[t.dtype for t in tensors]}")
    for t in tensors:
        if dtype == torch.bfloat16:
            tma_map_params(t)
        elif t.stride(-1) != 1 or any(x % 8 for x in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"attention tensors need a contiguous head dim and 16-byte "
                             f"aligned rows, got strides {t.stride()}")


def _ptr_strides(t):
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def _forward_kernel(q, k, v, with_lse: bool):
    _build.require_cuda(q, k, v)
    _check(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, s), device=q.device, dtype=torch.float32)
           if with_lse else None)
    lib = _build.load("encoder_attention", _SIG)
    args = []
    for t in (q, k, v, out):
        args += _ptr_strides(t)
    _build.check(lib.twt_encoder_attention(
        _build.dtype_code(q), b, s, h, *args, None if lse is None else lse.data_ptr(),
        tma_map_words(q, k, v), d ** -0.5, _build.stream_of(q)), "encoder attention kernel")
    encoder_attention.launches += 1
    return out, lse


def encoder_attention_backward(q, k, v, out, lse, dout):
    """(dq, dk, dv), [B, S, H, Dh] in q's dtype, from the forward's ``out``
    and ``lse``. On CPU tensors: the plain version's gradients."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, dout)
    _build.require_cuda(q, k, v, out, lse, dout)
    if dout.stride(-1) != 1 or any(x % 8 for x in dout.stride()[:3]) or dout.data_ptr() % 16:
        dout = dout.contiguous()
    _check(q, k, v, out, dout)
    b, s, h, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [B, H, S], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    grads = [torch.empty_like(q, memory_format=torch.contiguous_format) for _ in range(3)]
    dbuf = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    lib = _build.load("encoder_attention_bwd", _SIG_BWD)
    args = []
    for t in (q, k, v, out, dout):
        args += _ptr_strides(t)
    args += [lse.data_ptr(), dbuf.data_ptr()]
    for t in grads:
        args += _ptr_strides(t)
    _build.check(lib.twt_encoder_attention_bwd(
        _build.dtype_code(q), b, s, h, *args, tma_map_words(q, k, v, dout), d ** -0.5,
        _build.stream_of(q)),
        "encoder attention backward kernels")
    encoder_attention_backward.launches += 1
    return tuple(grads)


class EncoderAttention(torch.autograd.Function):
    """Encoder attention with the CUDA backward: the forward kernel writes
    the LSE, the backward recomputes P from it. Under per-layer
    checkpointing the forward runs twice per step (the forward pass and
    the recompute before the backward)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward_kernel(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return encoder_attention_backward(*ctx.saved_tensors, dout)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal MHA, [B, S, H, Dh] -> [B, S, H, Dh] in q's dtype,
    differentiable."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return EncoderAttention.apply(q, k, v)
    return _forward_kernel(q, k, v, with_lse=False)[0]


def encoder_attention_lse(q, k, v):
    """(out, lse) of one forward launch that writes the LSE (what the
    differentiable path runs), for checking the LSE output on its own."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v), lse_plain(q, k)
    return _forward_kernel(q, k, v, with_lse=True)


def _check_decoder(q, k, v, causal: bool):
    b, sq, h, d = q.shape
    if (d != HEAD_DIM or k.dim() != 4 or k.shape != v.shape
            or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d)):
        raise ValueError(f"decoder attention takes q [B,Sq,H,64] and k, v [B,Sk,H,64], got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    if causal and k.shape[1] != sq:
        raise ValueError(f"causal decoder attention needs Sq == Sk, got {sq} and {k.shape[1]}")


def decoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """MHA of q [B, Sq, H, 64] over k/v [B, Sk, H, 64] -> [B, Sq, H, 64] in
    q's dtype, no gradient: ``causal`` (Sq == Sk) lets query i see keys
    0..i. On CPU tensors the plain version with the tril mask; on CUDA
    tensors the bf16 kernel (it raises on any other dtype)."""
    _check_decoder(q, k, v, causal)
    b, sq, h, d = q.shape
    if q.device.type == "cpu":
        mask = (torch.tril(torch.ones(sq, sq, dtype=torch.bool))[None, None]
                if causal else None)
        return attention_plain(q, k, v, mask)
    _build.require_cuda(q, k, v)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"the decoder attention kernel takes bf16, got "
                         f"{[t.dtype for t in (q, k, v)]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the decoder attention kernel has no backward: call it without a "
                         "gradient recorded")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("encoder_attention", _SIG)
    _build.check(lib.twt_decoder_attention(
        b, sq, k.shape[1], h, q.data_ptr(), k.data_ptr(), v.data_ptr(), *_ptr_strides(out),
        tma_map_words(q, k, v), d ** -0.5, int(causal), _build.stream_of(q)),
        "decoder attention kernel")
    decoder_attention.launches += 1
    return out


encoder_attention.launches = 0
encoder_attention_backward.launches = 0
decoder_attention.launches = 0
