"""Subtitle readers (SRT/VTT), test-set building from subtitle pairs, and
the SRT/VTT writers of ``cli transcribe`` (a copy of
taiwan_whisper_tpu/text/subtitles.py; the port imports nothing of the JAX
package).

The JAX module is a behavioral port of utils/transcript_readers.py (read_vtt,
timecode_to_seconds) and utils/segment_audio.py:14-70 (srt -> per-cue
flac/txt pairs for COOL-TEST style evaluation sets), minus the filesystem
specifics. Robust to the common SRT blank-line variants instead of the
reference's fixed 4-line stride.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Sequence, Tuple

import numpy as np

_SRT_TIME = re.compile(r"(\d{1,2}):(\d{2}):(\d{2})[,.](\d{1,3})")


@dataclasses.dataclass
class Cue:
    start: float  # seconds
    end: float
    text: str


def timecode_to_seconds(timecode: str) -> float:
    """'HH:MM:SS.mmm' / 'MM:SS.mmm' / 'SS.mmm' -> seconds (reference
    timecode_to_seconds semantics)."""
    items = timecode.strip().split(":")
    seconds = float(items[-1].replace(",", "."))
    if len(items) >= 2:
        seconds += int(items[-2]) * 60
    if len(items) >= 3:
        seconds += int(items[-3]) * 3600
    return seconds


def read_srt(path: str) -> List[Cue]:
    cues: List[Cue] = []
    with open(path, encoding="utf-8-sig") as f:
        content = f.read()
    for block in re.split(r"\n\s*\n", content):
        lines = [l.strip() for l in block.strip().splitlines()]
        if len(lines) < 2:
            continue
        # find the timing line
        t_idx = next((i for i, l in enumerate(lines) if "-->" in l), None)
        if t_idx is None:
            continue
        times = _SRT_TIME.findall(lines[t_idx])
        if len(times) < 2:
            continue

        def to_s(groups):
            h, m, s, ms = groups
            return int(h) * 3600 + int(m) * 60 + int(s) + int(ms.ljust(3, "0")) / 1000.0

        text = " ".join(lines[t_idx + 1 :]).strip()
        if text:
            cues.append(Cue(to_s(times[0]), to_s(times[1]), text))
    return cues


def read_vtt(path: str) -> List[Cue]:
    """WEBVTT cues: any line containing '-->' starts a cue whose text is the
    following line (reference read_vtt)."""
    cues: List[Cue] = []
    with open(path, encoding="utf-8-sig") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if "-->" not in line:
            continue
        items = line.split("-->")
        if len(items) != 2:
            continue
        start = timecode_to_seconds(items[0])
        end = timecode_to_seconds(items[1].split(" ")[0] or items[1])
        text = lines[i + 1].strip() if i + 1 < len(lines) else ""
        if text:
            cues.append(Cue(start, end, text))
    return cues


def read_subtitles(path: str) -> List[Cue]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".srt":
        return read_srt(path)
    if ext == ".vtt":
        return read_vtt(path)
    raise ValueError(f"unsupported subtitle format {ext!r}")


def cut_cue_pairs(
    audio: np.ndarray,
    cues: Sequence[Cue],
    sample_rate: int = 16000,
    max_seconds: float = 30.0,
) -> List[Tuple[np.ndarray, str]]:
    """Per-cue (audio slice, text) pairs, dropping cues that run past the
    audio or exceed the window (the reference's per-cue test-set cutter,
    utils/segment_audio.py:60-70)."""
    out: List[Tuple[np.ndarray, str]] = []
    n = len(audio)
    for cue in cues:
        s = int(cue.start * sample_rate)
        e = int(cue.end * sample_rate)
        if e > n or e - s > max_seconds * sample_rate or e <= s:
            continue
        out.append((audio[s:e], cue.text))
    return out


def build_test_set(
    audio_path: str,
    subtitle_path: str,
    output_dir: str,
    audio_format: str = "flac",
) -> List[str]:
    """Write <output_dir>/<stem>/NNNNN.{flac,txt} per cue; returns rel paths."""
    from ..audio.io import load_audio_16k, write_flac, write_wav

    stem = os.path.splitext(os.path.basename(audio_path))[0]
    sub_dir = os.path.join(output_dir, stem)
    os.makedirs(sub_dir, exist_ok=True)
    audio = load_audio_16k(audio_path)
    cues = read_subtitles(subtitle_path)
    rels: List[str] = []
    for i, (chunk, text) in enumerate(cut_cue_pairs(audio, cues)):
        base = f"{i:05d}"
        apath = os.path.join(sub_dir, f"{base}.{audio_format}")
        if audio_format == "flac":
            write_flac(apath, chunk)
        else:
            write_wav(apath, chunk)
        with open(os.path.join(sub_dir, f"{base}.txt"), "w", encoding="utf-8") as f:
            f.write(text + "\n")
        rels.append(os.path.join(stem, f"{base}.{audio_format}"))
    return rels


def _fmt_timecode(seconds: float, sep: str) -> str:
    ms = int(round(max(seconds, 0.0) * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def write_srt(path: str, cues: Sequence[Cue]) -> None:
    """SubRip writer (inverse of read_srt)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, c in enumerate(cues, start=1):
            f.write(f"{i}\n{_fmt_timecode(c.start, ',')} --> "
                    f"{_fmt_timecode(c.end, ',')}\n{c.text.strip()}\n\n")


def write_vtt(path: str, cues: Sequence[Cue]) -> None:
    """WebVTT writer (inverse of read_vtt)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("WEBVTT\n\n")
        for c in cues:
            f.write(f"{_fmt_timecode(c.start, '.')} --> "
                    f"{_fmt_timecode(c.end, '.')}\n{c.text.strip()}\n\n")
