"""Seeded inputs: lecture audio, training segments with transcripts, and
the byte-level vocabulary the training cells tokenise with.

``synth_speech`` and ``synth_lecture`` are frozen copies of
``taiwan_whisper_tpu_torch/tools/synth_audio.py`` at 2a03127: formant
pseudo-speech (the spectral VAD rejects noise by design) in bursts of
12-28 s between gaps of 2-5 s. ``with_noise_floor`` adds a room-noise
floor so that the VAD decides on audio rather than on digital zeros.
Everything else here is the benchmark's own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import wave
from typing import Dict, List, Sequence, Tuple

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


def with_noise_floor(rng: np.random.RandomState, audio: np.ndarray,
                     dbfs: float) -> np.ndarray:
    """``audio`` plus white noise whose RMS is ``dbfs`` below full scale."""
    rms = 10.0 ** (dbfs / 20.0)
    return (audio + rng.standard_normal(len(audio)).astype(np.float32) * rms).astype(np.float32)


def to_pcm16(audio: np.ndarray) -> np.ndarray:
    return np.clip(np.round(audio.astype(np.float32) * 32768.0), -32768, 32767).astype(np.int16)


def write_wav(path: str, pcm16: np.ndarray):
    """Mono 16 kHz PCM16 WAV."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm16.astype("<i2").tobytes())


def read_wav(path: str) -> np.ndarray:
    """The int16 samples of a file ``write_wav`` wrote."""
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.int16)


def link_or_copy(src: str, dst: str):
    """A second name for the same bytes: a hard link writes nothing."""
    try:
        os.link(src, dst)
    except OSError:
        with open(src, "rb") as a, open(dst, "wb") as b:
            b.write(a.read())


def burst_schedule(total_s: float, base_s: float = 300.0) -> List[Tuple[float, float]]:
    """(gap, speech) seconds of the bursts of a lecture of about ``total_s``:
    ``round(total_s / base_s)`` copies of one fixed set of bursts drawn as
    ``synth_lecture`` draws them (gaps of 2-5 s, speech of 12-28 s) until
    ``base_s``. Every seed and every lecture has the same bursts, so a
    corpus of so many bursts holds the same audio whatever its order."""
    rng = np.random.RandomState(1000)
    base, t = [], 0.0
    while True:
        gap, sp = rng.uniform(2.0, 5.0), rng.uniform(12.0, 28.0)
        if t + gap + sp > base_s:
            break
        base.append((gap, sp))
        t += gap + sp
    return base * max(1, int(round(total_s / base_s)))


@dataclasses.dataclass
class Lecture:
    path: str
    bursts: List[Tuple[int, int]]  # (first, end) sample of each speech burst
    pcm: np.ndarray


def lecture(rng: np.random.RandomState, schedule: Sequence[Tuple[float, float]],
            noise_dbfs: float) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """The bursts of ``schedule`` in a seeded order, each of fresh
    pseudo-speech after its gap, then 2 s of silence, over a noise floor:
    (int16 samples, burst sample spans)."""
    audio = np.zeros(sum(int(g * SR) + int(s * SR) for g, s in schedule) + 2 * SR, np.float32)
    bursts, t = [], 0
    for j in rng.permutation(len(schedule)):
        gap, sp = schedule[int(j)]
        t += int(gap * SR)
        speech = synth_speech(rng, sp)
        audio[t:t + len(speech)] = speech
        bursts.append((t, t + len(speech)))
        t += len(speech)
    return to_pcm16(with_noise_floor(rng, audio, noise_dbfs)), bursts


def lecture_pool(rng: np.random.RandomState, out_dir: str, seconds: Sequence[float],
                 noise_dbfs: float, base_s: float = 300.0) -> List[Lecture]:
    """One WAV per entry of ``seconds``, each from its fixed burst schedule
    (the same lengths and bursts for every seed, in a seeded order)."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for i, s in enumerate(seconds):
        pcm, bursts = lecture(rng, burst_schedule(s, base_s), noise_dbfs)
        path = os.path.join(out_dir, f"pool{i}.wav")
        write_wav(path, pcm)
        out.append(Lecture(path, bursts, pcm))
    return out


# ---------------------------------------------------------------------------
# training segments: 8-30 s of speech with 2-line code-switched transcripts,
# as ``cli segment`` writes them (transcript / previous transcript)
# ---------------------------------------------------------------------------

_ZH = ("我們今天來談一下這個模型的訓練方法然後看資料怎麼處理所以大家可以先想想看"
       "老師說明天要考試因為這一段很重要我覺得其實沒有那麼難")
_EN = ("model", "training", "data", "loss", "GPU", "batch", "attention", "okay", "so",
       "the", "transformer", "decoder", "encoder", "token")


def _utterance(rng: np.random.RandomState, n_chars: int) -> str:
    out = []
    while len("".join(out)) < n_chars:
        if rng.rand() < 0.25:
            out.append(" " + _EN[rng.randint(len(_EN))] + " ")
        else:
            k = rng.randint(2, 6)
            i = rng.randint(0, len(_ZH) - k)
            out.append(_ZH[i:i + k])
    return "".join(out).strip()


def _stamp(t: float) -> str:
    return f"<|{t:.2f}|>"


def transcript(rng: np.random.RandomState, dur: float) -> str:
    """Timestamped utterances inside ``dur`` seconds, ending on a
    timestamp, then ``<|endoftext|>``."""
    parts, t = [], rng.uniform(0.0, 0.6)
    while True:
        d = rng.uniform(1.5, 6.0)
        if t + d > dur - 0.1:
            break
        parts.append(_stamp(t) + _utterance(rng, int(d * 2.5)) + _stamp(t + d))
        t += d + rng.uniform(0.0, 0.8)
    if not parts:
        parts.append(_stamp(0.0) + _utterance(rng, 4) + _stamp(min(1.0, dur)))
    return "".join(parts) + "<|endoftext|>"


def segment_corpus(rng: np.random.RandomState, out_dir: str, n: int, pool: int,
                   seconds: Tuple[float, float], noise_dbfs: float) -> str:
    """``n`` segments of ``seconds`` (uniform) with transcripts, their audio
    drawn in a seeded order from ``pool`` distinct clips (one per length
    class, the lengths the same for every seed); returns the manifest path
    (fairseq TSV: the root, then one relative path a line)."""
    os.makedirs(out_dir, exist_ok=True)
    lo, hi = seconds
    lengths = lo + (hi - lo) * (np.arange(pool) + 0.5) / pool
    clips = []
    for i, s in enumerate(lengths):
        audio = with_noise_floor(rng, synth_speech(rng, float(s)), noise_dbfs)
        path = os.path.join(out_dir, f"clip{i}.wav")
        write_wav(path, to_pcm16(audio))
        clips.append((path, float(s)))
    order = np.concatenate([rng.permutation(pool) for _ in range(-(-n // pool))])[:n]
    names, prev = [], _stamp(0.0) + _utterance(rng, 6) + _stamp(2.0) + "<|endoftext|>"
    for j, c in enumerate(order):
        src, dur = clips[int(c)]
        name = f"seg{j:05d}.wav"
        link_or_copy(src, os.path.join(out_dir, name))
        text = transcript(rng, dur)
        with open(os.path.join(out_dir, f"seg{j:05d}.txt"), "w", encoding="utf-8") as f:
            f.write(text + "\n" + prev + "\n")
        prev = text
        names.append(name)
    manifest = os.path.join(out_dir, "train.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(out_dir + "\n")
        for name in names:
            f.write(name + "\n")
    return manifest


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def byte_vocab() -> Dict[str, int]:
    """One id per byte, in the mapping's order: text ids are 0-255."""
    return {ch: i for i, ch in enumerate(bytes_to_unicode().values())}


def write_byte_tokenizer(out_dir: str) -> str:
    """vocab.json and an empty merges.txt: byte-level BPE with no merges."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(byte_vocab(), f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    return out_dir
