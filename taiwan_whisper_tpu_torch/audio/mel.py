"""Log-mel spectrogram frontend (port of taiwan_whisper_tpu/audio/mel.py).

The 400-point rFFT is two products against fixed window-folded cosine/sine
DFT matrices built with numpy (the same matrices as the JAX package);
framing is a reflect pad, a reshape and two shifted concats. ``log_mel`` is
the plain PyTorch version; ops/mel_kernel.py holds the fused CUDA kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
N_FREQS = N_FFT // 2 + 1  # 201


def hertz_to_mel(freq):
    """Slaney-scale mel (matches transformers.audio_utils, mel_scale="slaney")."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freq,
    )


@functools.lru_cache(maxsize=8)
def mel_filter_bank(
    num_mel_bins: int = 80,
    num_freqs: int = N_FREQS,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Slaney-normalised triangular filters, shape [num_freqs, num_mel_bins]."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2, num_freqs)
    mel_min = hertz_to_mel(min_frequency)
    mel_max = hertz_to_mel(max_frequency)
    filter_freqs = mel_to_hertz(np.linspace(mel_min, mel_max, num_mel_bins + 2))

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (filter_freqs[2: num_mel_bins + 2] - filter_freqs[:num_mel_bins])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=2)
def dft_matrices() -> tuple:
    """Window-combined DFT matrices W_cos, W_sin of shape [N_FFT, N_FREQS]
    (periodic Hann window folded in)."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    n = np.arange(N_FFT)[:, None]
    k = np.arange(N_FREQS)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    w_cos = (np.cos(ang) * window[:, None]).astype(np.float32)
    w_sin = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return w_cos, w_sin


def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N + N_FFT] with center (reflect) padding."""
    pad = N_FFT // 2
    return F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]


def frame_audio(audio: torch.Tensor) -> torch.Tensor:
    """[B, N] -> frames [B, N // HOP, N_FFT] via reshape + shifted concat."""
    b, n = audio.shape
    assert n % HOP_LENGTH == 0, f"audio length {n} must be a multiple of {HOP_LENGTH}"
    x = reflect_pad(audio)
    total = x.shape[1]
    rows = -(-total // HOP_LENGTH)  # ceil
    x = F.pad(x, (0, rows * HOP_LENGTH - total))
    x2 = x.reshape(b, rows, HOP_LENGTH)
    stacked = torch.cat([x2[:, :-2], x2[:, 1:-1], x2[:, 2:]], dim=-1)
    n_frames = n // HOP_LENGTH  # whisper drops the final (n/hop + 1)th frame
    return stacked[:, :n_frames, :N_FFT]


def log_mel_tail(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-utterance max-8 floor and (x+4)/4 on a log10 mel spectrogram."""
    maxes = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, maxes - 8.0)
    return (log_spec + 4.0) / 4.0


def log10_mel_spectrum(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """[B, N] fp32 -> log10(max(mel power, 1e-10)), [B, N // HOP, num_mel_bins]."""
    frames = frame_audio(audio.float())
    w_cos, w_sin = dft_matrices()
    dev = audio.device
    re = frames @ torch.from_numpy(w_cos).to(dev)
    im = frames @ torch.from_numpy(w_sin).to(dev)
    power = re * re + im * im
    mel = power @ torch.from_numpy(mel_filter_bank(num_mel_bins)).to(dev)
    return torch.log10(torch.clamp(mel, min=1e-10))


def log_mel(audio: torch.Tensor, num_mel_bins: int = 80) -> torch.Tensor:
    """Whisper log-mel features: [B, N] -> [B, N // HOP, num_mel_bins] fp32
    (log10 clamp at 1e-10, per-utterance max-8 floor, (x+4)/4)."""
    return log_mel_tail(log10_mel_spectrum(audio, num_mel_bins))


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Host-side pad/trim to exactly `length` samples."""
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)
