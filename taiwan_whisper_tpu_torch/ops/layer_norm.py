"""Row LayerNorm: the CUDA kernel and its plain version.

Replaces taiwan_whisper_tpu/ops/layer_norm.py::layer_norm_pallas. The
kernel (csrc/layer_norm.cu) normalises each row over the last axis d (a
multiple of 128) with fp32 mean and centred variance and writes x's dtype:
one read and one write of the row, so it is bound by bytes. One warp
takes a row, holding it in registers in 16-byte packs (d <= 2048) or
making two passes over it (larger d, the second from L2); ``launch_plan``
picks the route, the chunks and the grid. Scale and bias are rounded to
x's dtype, as the TPU kernel does (``layer_norm.py:71``); the kernel takes
them in fp32 or in x's dtype and rounds them itself.

Like the JAX package's kernel it is not wired into the model, which keeps
its fp32 ``_layer_norm``; it is held against its plain version on the card.
"""

from __future__ import annotations

import torch

from . import _build

_SIG = {"twt_layer_norm": [_build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
                           _build.L, _build.I, _build.F, _build.I, _build.I, _build.P]}
WARPS = 8               # warps per block, one a row (csrc/layer_norm.cu)
MAX_RESIDENT_D = 2048   # the widest row held in registers; wider rows take two passes


def supported(d: int) -> bool:
    return d % 128 == 0


def launch_plan(n_rows: int, d: int, itemsize: int) -> dict:
    """How the kernel runs [n_rows, d] of ``itemsize``-byte elements:
    ``chunks`` 16-byte packs per lane cover a row, the route is "resident"
    (the row in registers) up to MAX_RESIDENT_D and "streamed" (two passes)
    above, and the grid has a warp for every row."""
    chunks = -(-d // (32 * 16 // itemsize))
    return dict(route="resident" if d <= MAX_RESIDENT_D else "streamed", chunks=chunks,
                grid=-(-n_rows // WARPS))


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
        raise ValueError(f"layer norm kernel takes d % 128 == 0, got {d}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer norm kernel takes bf16 or fp32, got {x.dtype}")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale and bias must be [{d}], got {tuple(scale.shape)} "
                         f"{tuple(bias.shape)}")
    if scale.dtype != bias.dtype or scale.dtype not in (torch.float32, x.dtype):
        # the kernel takes fp32 or x's dtype and rounds them itself; other
        # dtypes are rounded here
        scale, bias = scale.to(x.dtype), bias.to(x.dtype)
    scale, bias = scale.contiguous(), bias.contiguous()
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer norm kernel takes contiguous, 16-byte aligned x")
    y = torch.empty_like(x)
    n_rows = x.numel() // d
    if n_rows == 0:
        return y
    plan = launch_plan(n_rows, d, x.element_size())
    lib = _build.load("layer_norm", _SIG)
    _build.check(lib.twt_layer_norm(
        _build.dtype_code(x), int(scale.dtype == torch.float32), x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), n_rows, d, eps, plan["chunks"], plan["grid"],
        _build.stream_of(x)), "layer norm kernel")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
