"""Speech-like synthetic audio from a seed, for the card's smoke run and the
labelling profile (the spectral VAD rejects noise by design, so a labelling
run with VAD on needs audio it takes for speech).

``synth_speech``: a glottal pulse train with a drifting f0 through two
formant resonators per syllable, syllable-rate (3-5 Hz) envelopes and
short pauses. ``synth_lecture``: speech bursts of 12-28 s between silent
gaps of 2-5 s, the shape of lecture audio that VAD regions exist for.
``write_lecture_flacs``: a corpus of such lectures as FLAC files.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

SR = 16000


def synth_speech(rng: np.random.RandomState, dur: float, level: float = 0.15) -> np.ndarray:
    """``dur`` seconds of formant-synthesised pseudo-speech, peak ``level``."""
    n = int(dur * SR)
    out = np.zeros(n, np.float64)
    t = 0
    while t < n:
        syl = int(rng.uniform(0.12, 0.28) * SR)
        if rng.rand() < 0.15:
            t += int(rng.uniform(0.05, 0.25) * SR)
            continue
        f0 = rng.uniform(90, 220)
        seg = np.zeros(syl)
        seg[:: max(int(SR / f0), 1)] = 1.0
        y = seg
        for fc, bw in [(rng.uniform(300, 900), 80), (rng.uniform(1000, 2600), 120)]:
            k = np.arange(int(SR * 0.02))
            h = np.exp(-np.pi * bw * k / SR) * np.sin(2 * np.pi * fc * k / SR)
            y = np.convolve(y, h)[:syl]
        y *= np.hanning(syl) ** 0.7
        end = min(t + syl, n)
        out[t:end] += y[: end - t]
        t = end
    return (out / (np.abs(out).max() + 1e-9) * level).astype(np.float32)


def synth_lecture(rng: np.random.RandomState, total_s: float) -> np.ndarray:
    """About ``total_s`` seconds (at least) of speech bursts between gaps."""
    parts, t = [], 0.0
    while t < total_s:
        gap = rng.uniform(2.0, 5.0)
        parts.append(np.zeros(int(gap * SR), np.float32))
        t += gap
        sp = min(rng.uniform(12.0, 28.0), total_s - t)
        if sp > 1.0:
            parts.append(synth_speech(rng, sp))
            t += sp
    return np.concatenate(parts)


def write_lecture_flacs(out_dir: str, n: int, seconds: float, seed: int) -> List[str]:
    """``n`` FLAC files of ``seconds`` of lecture audio each, from ``seed``,
    written by the port's encoder; returns their names."""
    from ..audio.io import write_flac

    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        names.append(f"lecture{i}.flac")
        write_flac(os.path.join(out_dir, names[-1]),
                   synth_lecture(rng, seconds)[: int(seconds * SR)])
    return names
