"""Fused log-mel kernel (CUDA) and its plain PyTorch version.

Replaces taiwan_whisper_tpu/ops/mel_kernel.py::log_mel_pallas. The kernel
(csrc/mel.cu) computes frames @ W_cos / W_sin, the power spectrum, the
mel product and log10 in one pass per (utterance, 32-frame tile); the power
spectrum never reaches device memory. It is bound by fp32 operations
(~34 GFLOP at 32 x 30 s). Framing is folded into the kernel (it reads the
reflect-padded audio directly); the max-8 floor and (x+4)/4 stay PyTorch.
On CPU tensors the wrapper runs the plain version, audio.mel's.
"""

from __future__ import annotations

import functools

import torch

from ..audio import mel as A
from . import _build

_SIG = {"twt_log_mel": [_build.P, _build.L, _build.I, _build.P, _build.P,
                        _build.P, _build.P, _build.I, _build.I, _build.P]}

log10_mel_spectrum_plain = A.log10_mel_spectrum


@functools.lru_cache(maxsize=4)
def _operands(device: torch.device, num_mel_bins: int):
    w_cos, w_sin = A.dft_matrices()
    return (torch.from_numpy(w_cos).to(device), torch.from_numpy(w_sin).to(device),
            torch.from_numpy(A.mel_filter_bank(num_mel_bins)).to(device))


def log10_mel_spectrum(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """[B, N] fp32 -> log10(max(mel, 1e-10)) [B, N // 160, num_mel_bins] fp32."""
    if audio.device.type == "cpu":
        return log10_mel_spectrum_plain(audio, num_mel_bins)
    _build.require_cuda(audio)
    if audio.dtype != torch.float32 or audio.dim() != 2:
        raise ValueError(f"audio must be [B, N] float32, got {audio.dtype} {tuple(audio.shape)}")
    b, n = audio.shape
    if n % A.HOP_LENGTH:
        raise ValueError(f"audio length {n} must be a multiple of {A.HOP_LENGTH}")
    padded = A.reflect_pad(audio).contiguous()
    n_frames = n // A.HOP_LENGTH
    wc, ws, fb = _operands(audio.device, num_mel_bins)
    out = torch.empty((b, n_frames, num_mel_bins), device=audio.device, dtype=torch.float32)
    lib = _build.load("mel", _SIG)
    _build.check(lib.twt_log_mel(
        padded.data_ptr(), padded.shape[1], b, wc.data_ptr(), ws.data_ptr(),
        fb.data_ptr(), out.data_ptr(), n_frames, num_mel_bins,
        _build.stream_of(audio)), "log_mel kernel")
    log10_mel_spectrum.launches += 1
    return out


log10_mel_spectrum.launches = 0


def log_mel(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Whisper log-mel features through the fused kernel: [B, N] -> [B, N // 160, M]."""
    return A.log_mel_tail(log10_mel_spectrum(audio, num_mel_bins))
