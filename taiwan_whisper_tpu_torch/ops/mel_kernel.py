"""Log-mel spectrum kernel (CUDA) and its plain PyTorch version.

Replaces taiwan_whisper_tpu/ops/mel_kernel.py::log_mel_pallas. The kernel
(csrc/mel.cu) reads the unpadded [B, N] audio with the reflect pad folded
into its loads and, per (utterance, 32-frame tile), runs each frame's
400-point real FFT (a 200-point complex FFT, radix 8 x 5 x 5, and a split
into the 201 bins), the power, the sparse mel product and log10 in one
launch; the power never reaches device memory. It is bound by bytes (the
audio in and the log-mel out). The TPU's DFT-matrix products compute the
same spectrum; the window, the twiddles and the filter slices the kernel
takes are built here (``fft_tables``, ``mel_slices``). The max-8 floor and
(x+4)/4 stay PyTorch. On CPU tensors the wrapper runs the plain version,
audio.mel's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio import mel as A
from . import _build

_SIG = {"twt_log_mel": [_build.P, _build.L, _build.I, _build.P, _build.P, _build.P,
                        _build.I, _build.P, _build.I, _build.I, _build.P]}
MAX_MELS = 128     # csrc/mel.cu's shared-memory room for the filters
MAX_WEIGHTS = 512
FRAMES_PER_TILE = 32
BLOCKS_PER_SM = 2  # csrc/mel.cu's blocks resident on an SM (its shared memory)

log10_mel_spectrum_plain = A.log10_mel_spectrum


@functools.lru_cache(maxsize=2)
def fft_tables(dtype=np.float32) -> np.ndarray:
    """The kernel's window and twiddles as one flat array: the periodic
    Hann window [400], then W_400^j = exp(-2 pi i j / 400) for j < 400 as
    (re, im) pairs. Computed in float64 and rounded to ``dtype``."""
    n = np.arange(A.N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / A.N_FFT))
    ang = 2.0 * np.pi * n / A.N_FFT
    twiddles = np.stack([np.cos(ang), -np.sin(ang)], axis=1).reshape(-1)
    return np.concatenate([window, twiddles]).astype(dtype)


@functools.lru_cache(maxsize=4)
def mel_slices(num_mel_bins: int):
    """``mel_filter_bank(num_mel_bins)`` as the kernel takes it: filter m
    weighs bins [start_m, start_m + count_m) by weights[offset_m:offset_m +
    count_m], from its first to its last nonzero. Returns int32 [M + 1, 2]
    rows (start_m, offset_m), the last row's offset being the weight count
    (so count_m = offset_(m+1) - offset_m), and the float32 weights."""
    fb = A.mel_filter_bank(num_mel_bins)
    spans, weights = [], []
    for m in range(num_mel_bins):
        nz = np.flatnonzero(fb[:, m])
        start, stop = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        spans.append((start, len(weights)))
        weights.extend(fb[start:stop, m])
    spans.append((0, len(weights)))
    return np.asarray(spans, np.int32), np.asarray(weights, np.float32)


def reflect_index(j, n: int):
    """The audio sample the kernel loads for padded position ``j``:
    ``reflect_pad(audio)[:, j] == audio[:, reflect_index(j, n)]``."""
    i = np.abs(np.asarray(j) - A.N_FFT // 2)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def launch_grid(batch: int, n: int, sms: int) -> int:
    """The kernel's persistent grid: as many blocks as stay resident on a
    card of ``sms`` SMs, or one a tile of 32 frames when there are fewer."""
    tiles = batch * -(-(n // A.HOP_LENGTH) // FRAMES_PER_TILE)
    return min(tiles, sms * BLOCKS_PER_SM)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4)
def _operands(device: torch.device, num_mel_bins: int):
    spans, weights = mel_slices(num_mel_bins)
    return (torch.from_numpy(fft_tables()).to(device), torch.from_numpy(spans).to(device),
            torch.from_numpy(weights).to(device))


def log10_mel_spectrum(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """[B, N] fp32 -> log10(max(mel, 1e-10)) [B, N // 160, num_mel_bins] fp32."""
    if audio.device.type == "cpu":
        return log10_mel_spectrum_plain(audio, num_mel_bins)
    _build.require_cuda(audio)
    if audio.dtype != torch.float32 or audio.dim() != 2:
        raise ValueError(f"audio must be [B, N] float32, got {audio.dtype} {tuple(audio.shape)}")
    b, n = audio.shape
    if n % A.HOP_LENGTH or n <= A.N_FFT // 2:
        raise ValueError(f"audio length {n} must be a multiple of {A.HOP_LENGTH} above "
                         f"{A.N_FFT // 2}")
    audio = audio.contiguous()
    if audio.data_ptr() % 16:
        raise ValueError("the log-mel kernel takes 16-byte aligned audio")
    if num_mel_bins > MAX_MELS or len(mel_slices(num_mel_bins)[1]) > MAX_WEIGHTS:
        raise ValueError(f"the log-mel kernel takes at most {MAX_MELS} mel bins, got "
                         f"{num_mel_bins}")
    table, spans, weights = _operands(audio.device, num_mel_bins)
    out = torch.empty((b, n // A.HOP_LENGTH, num_mel_bins), device=audio.device,
                      dtype=torch.float32)
    lib = _build.load("mel", _SIG)
    _build.check(lib.twt_log_mel(
        audio.data_ptr(), n, b, table.data_ptr(), spans.data_ptr(), weights.data_ptr(),
        weights.numel(), out.data_ptr(), num_mel_bins, launch_grid(b, n, _sms(audio.device)),
        _build.stream_of(audio)),
        "log_mel kernel")
    log10_mel_spectrum.launches += 1
    return out


log10_mel_spectrum.launches = 0


def log_mel(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Whisper log-mel features through the fused kernel: [B, N] -> [B, N // 160, M]."""
    return A.log_mel_tail(log10_mel_spectrum(audio, num_mel_bins))
