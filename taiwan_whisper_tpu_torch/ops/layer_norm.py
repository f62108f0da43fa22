"""Row LayerNorm: the CUDA kernel and its plain version.

Replaces taiwan_whisper_tpu/ops/layer_norm.py::layer_norm_pallas. The
kernel (csrc/layer_norm.cu) normalises each row over the last axis d (a
multiple of 128, at most 2048) with one warp per row, fp32 mean and
centred variance in registers, and writes x's dtype: one read and one
write of the row, so it is bound by bytes. Scale and bias are rounded to
x's dtype first, as the TPU kernel does (``layer_norm.py:71``).

Like the JAX package's kernel it is not wired into the model, which keeps
its fp32 ``_layer_norm``; it is held against its plain version on the card.
"""

from __future__ import annotations

import torch

from . import _build

_SIG = {"twt_layer_norm": [_build.I, _build.P, _build.P, _build.P, _build.P, _build.L,
                           _build.I, _build.F, _build.P]}
MAX_D = 2048


def supported(d: int) -> bool:
    return d % 128 == 0 and d <= MAX_D


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm (the model's ``_layer_norm``) with scale and bias
    rounded to x's dtype; returns x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * scale.to(x.dtype).float() + bias.to(x.dtype).float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` [..., d]; returns x's dtype."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _build.require_cuda(x, scale, bias)
    d = x.shape[-1]
    if not supported(d):
        raise ValueError(f"layer norm kernel takes d % 128 == 0 and d <= {MAX_D}, got {d}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer norm kernel takes bf16 or fp32, got {x.dtype}")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale and bias must be [{d}], got {tuple(scale.shape)} "
                         f"{tuple(bias.shape)}")
    sc = scale.to(x.dtype).contiguous()
    bi = bias.to(x.dtype).contiguous()
    if not x.is_contiguous() or any(t.data_ptr() % 16 for t in (x, sc, bi)):
        raise ValueError("layer norm kernel takes contiguous, 16-byte aligned tensors")
    y = torch.empty_like(x)
    lib = _build.load("layer_norm", _SIG)
    _build.check(lib.twt_layer_norm(_build.dtype_code(x), x.data_ptr(), sc.data_ptr(),
                                    bi.data_ptr(), y.data_ptr(), x.numel() // d, d, eps,
                                    _build.stream_of(x)), "layer norm kernel")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
