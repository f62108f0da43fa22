"""ctypes binding of the repository's native C++ helpers
(``native/twt_native.cpp``: edit distance, n-gram count;
``native/flac_codec.cpp``: FLAC decode and encode).

The two sources are compiled together with ``g++`` at first use into
``build/native/<hash of the sources>/libtwt_native.so`` beside the package
(``build/`` is git-ignored), never beside the sources; a failed build
raises. The entry points take and return numpy arrays and Python values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = [os.path.join(_ROOT, "native", "twt_native.cpp"),
           os.path.join(_ROOT, "native", "flac_codec.cpp")]
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIGS = {
    "tw_edit_distance_u32": (ctypes.c_int32, [_U32P, ctypes.c_int32, _U32P, ctypes.c_int32]),
    "tw_max_ngram_count_u32": (ctypes.c_int32, [_U32P, ctypes.c_int32, ctypes.c_int32]),
    "tw_flac_decode_file": (ctypes.c_int32, [
        ctypes.c_char_p, ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int64),
        _I32P, _I32P, _I32P]),
    "tw_flac_encode_file": (ctypes.c_int32, [
        ctypes.c_char_p, _I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]),
    "tw_free": (None, [ctypes.c_void_p]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the library of the current sources is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_ROOT, "build", "native", h.hexdigest()[:16], "libtwt_native.so")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                out = subprocess.run(["g++", *_FLAGS, "-o", tmp, *SOURCES],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"g++ failed to build the native helpers:\n"
                                       f"{out.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            for name, (restype, argtypes) in _SIGS.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _intern(seq: Sequence, table: dict) -> np.ndarray:
    out = np.empty(len(seq), dtype=np.uint32)
    for i, tok in enumerate(seq):
        out[i] = table.setdefault(tok, len(table))
    return out


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (str units)."""
    table: dict = {}
    aa = _intern(a, table)
    bb = _intern(b, table)
    return int(_load().tw_edit_distance_u32(
        aa.ctypes.data_as(_U32P), len(aa), bb.ctypes.data_as(_U32P), len(bb)))


def max_ngram_count(text: str, n: int = 6) -> int:
    """Max character-n-gram repetition count (marker spans skipped)."""
    arr = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32).copy()
    return int(_load().tw_max_ngram_count_u32(arr.ctypes.data_as(_U32P), len(arr), n))


def flac_decode(path: str):
    """Decode a FLAC file -> (float32 array [T] or [T, C], sample_rate)."""
    lib = _load()
    pcm = _I32P()
    frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    bps = ctypes.c_int32()
    rc = lib.tw_flac_decode_file(
        path.encode(), ctypes.byref(pcm), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (rc={rc}): {path}")
    n = frames.value * channels.value
    try:
        arr = np.ctypeslib.as_array(pcm, shape=(n,)).copy()
    finally:
        lib.tw_free(pcm)
    data = arr.astype(np.float32) / float(1 << (bps.value - 1))
    if channels.value > 1:
        data = data.reshape(frames.value, channels.value)
    return data, rate.value


def flac_encode(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Encode float32 audio ([T] or [T, C]) to 16-bit FLAC."""
    lib = _load()
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        frames, channels = audio.shape[0], 1
    else:
        frames, channels = audio.shape
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int32)
    pcm = np.ascontiguousarray(pcm.reshape(-1))
    rc = lib.tw_flac_encode_file(path.encode(), pcm.ctypes.data_as(_I32P), frames,
                                 channels, sample_rate)
    if rc != 0:
        raise ValueError(f"FLAC encode failed (rc={rc}): {path}")
