"""Corpus ingest utilities: format conversion and duration bookkeeping
(port of taiwan_whisper_tpu/audio/ingest.py; host code only).

Covers the reference's ingest scripts: webm/m4a -> 16 kHz mono FLAC
conversion (pseudo-labelling/filter_data.py, webm2flac.py) and corpus
duration statistics (check_duration.py).

ffmpeg is the only practical decoder for webm/m4a; when it is absent the
converter raises with a clear message instead of silently skipping. WAV and
FLAC inputs convert with the port's own codecs (``audio/io.py``) and need
no external binary.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import shutil
import subprocess
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .io import load_audio_16k, write_flac

_FFMPEG_FORMATS = {".webm", ".m4a", ".mp3", ".mp4", ".ogg", ".opus", ".aac"}
_NATIVE_FORMATS = {".wav", ".flac"}


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def convert_to_flac_16k(
    src_path: str,
    dst_path: str,
    *,
    delete_original: bool = False,
) -> str:
    """Convert one audio file to 16 kHz mono FLAC (the corpus format every
    pipeline stage consumes)."""
    ext = os.path.splitext(src_path)[1].lower()
    os.makedirs(os.path.dirname(os.path.abspath(dst_path)), exist_ok=True)
    if ext in _NATIVE_FORMATS:
        audio = load_audio_16k(src_path)
        write_flac(dst_path, audio, 16000)
    elif ext in _FFMPEG_FORMATS:
        if not ffmpeg_available():
            raise RuntimeError(
                f"converting {ext} requires ffmpeg, which is not installed; "
                "wav/flac inputs convert natively"
            )
        subprocess.run(
            ["ffmpeg", "-y", "-i", src_path, "-ar", "16000", "-ac", "1",
             "-sample_fmt", "s16", dst_path],
            check=True, capture_output=True,
        )
    else:
        raise ValueError(f"unsupported input format {ext!r}")
    if delete_original and os.path.abspath(src_path) != os.path.abspath(dst_path):
        os.remove(src_path)
    return dst_path


def batch_convert(
    src_paths: Sequence[str],
    output_dir: str,
    *,
    num_workers: int = 8,
    delete_original: bool = False,
) -> List[Tuple[str, Optional[str]]]:
    """Threaded conversion (the reference uses ThreadPoolExecutor for its
    ffmpeg fan-out, webm2flac.py:5-53). Returns (src, dst-or-None) pairs;
    failures carry None and are reported, not fatal."""
    results: List[Tuple[str, Optional[str]]] = []

    def one(src: str) -> Tuple[str, Optional[str]]:
        stem = os.path.splitext(os.path.basename(src))[0]
        dst = os.path.join(output_dir, stem + ".flac")
        try:
            return src, convert_to_flac_16k(src, dst, delete_original=delete_original)
        except Exception as e:
            print(f"[ingest] failed {src}: {e}")
            return src, None

    with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
        for res in ex.map(one, src_paths):
            results.append(res)
    return results


@dataclasses.dataclass
class DurationStats:
    n_files: int
    total_seconds: float
    mean_seconds: float
    min_seconds: float
    max_seconds: float

    @property
    def total_hours(self) -> float:
        return self.total_seconds / 3600.0


def duration_stats(paths: Iterable[str]) -> DurationStats:
    """Per-corpus duration statistics (reference check_duration.py)."""
    durs: List[float] = []
    for p in paths:
        try:
            audio = load_audio_16k(p)
            durs.append(len(audio) / 16000.0)
        except Exception as e:
            print(f"[ingest] unreadable {p}: {e}")
    if not durs:
        return DurationStats(0, 0.0, 0.0, 0.0, 0.0)
    a = np.asarray(durs)
    return DurationStats(
        n_files=len(durs),
        total_seconds=float(a.sum()),
        mean_seconds=float(a.mean()),
        min_seconds=float(a.min()),
        max_seconds=float(a.max()),
    )
