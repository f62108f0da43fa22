"""Host-side audio ingest: WAV/FLAC read and write, mono, resample to 16 kHz.

Port of taiwan_whisper_tpu/audio/io.py: WAV through the standard library,
FLAC through the repository's C++ codec (``native/flac_codec.cpp``, bound
by utils/native.py).
"""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np

SAMPLE_RATE = 16000


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 array [T] or [T, C], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE):
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Read a FLAC file -> (float32 array [T] or [T, C], sample_rate)."""
    from ..utils.native import flac_decode

    return flac_decode(path)


def write_flac(path: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE):
    """Write float32 audio ([T] or [T, C]) as 16-bit FLAC."""
    from ..utils.native import flac_encode

    flac_encode(path, np.asarray(audio, np.float32), sample_rate)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        return read_flac(path)
    raise ValueError(f"unsupported audio format {ext!r} (wav/flac supported)")


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim == 2:
        return audio.mean(axis=1)
    return audio


def resample_linear(audio: np.ndarray, src_rate: int, dst_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Linear-interpolation resampler (mono)."""
    if src_rate == dst_rate:
        return audio.astype(np.float32)
    n_out = int(round(len(audio) * dst_rate / src_rate))
    x_out = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    return np.interp(x_out, np.arange(len(audio), dtype=np.float64), audio).astype(
        np.float32
    )


def load_audio_16k(path: str) -> np.ndarray:
    """Read a supported file -> float32 mono 16 kHz."""
    data, sr = read_audio(path)
    return resample_linear(to_mono(np.asarray(data, np.float32)), sr)
