"""Plain reference of the training batches: from a segment manifest and a
seed to the rows that a train step gets, as the K2D recipe builds them.

Per epoch the manifest's rows are shuffled by ``np.random.RandomState``
from the run's seed. Each row's transcript loses its ``<|endoftext|>``;
with more than one timestamp, text and audio are cut at the last
timestamp. Its label is ``<|startoftranscript|> <|zh|> <|transcribe|>``,
the transcript (timestamps as tokens, text as one token per UTF-8 byte:
the byte-level vocabulary with no merges) and ``<|endoftext|>``; with
probability ``timestamp_probability`` (one binomial draw) the timestamps
stay, else they go and ``<|notimestamps|>`` follows the task; with
probability ``condition_on_prev_probability`` (a second draw) the previous
transcript leads as a prompt after ``<|startofprev|>`` (its timestamps as
spaces when the label dropped its own), cut to its last 223 tokens and to
what fits 448 in all. Audio is padded or cut to 30 s; labels padded with
``<|endoftext|>`` to 448, shifted right into the decoder input, and every
position up to ``<|startoftranscript|>`` and past the end set to -100.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List

import numpy as np

from .. import synth
from . import rules as R

TS_RE = re.compile(r"<\|\d{1,2}\.\d{2}\|>")
MARK_RE = re.compile(r"<\|[^|]*\|>")
IGNORE = -100
SOT_PREV = 50361
TRANSCRIBE = 50359
ZH = R.SOT + 1 + 1
SPACE = 220


def _byte_ids() -> Dict[int, int]:
    order = list(synth.bytes_to_unicode())
    return {b: i for i, b in enumerate(order)}


_BYTE_ID = _byte_ids()


def encode(text: str) -> List[int]:
    """Markers to their ids, text to byte ids."""
    out: List[int] = []
    pos = 0
    for m in MARK_RE.finditer(text):
        out.extend(_BYTE_ID[b] for b in text[pos:m.start()].encode("utf-8"))
        mark = m.group(0)
        if TS_RE.fullmatch(mark):
            out.append(R.TS_BEGIN + max(0, min(int(round(float(mark[2:-2]) / 0.02)), 1500)))
        elif mark == "<|startofprev|>":
            out.append(SOT_PREV)
        elif mark == "<|endoftext|>":
            out.append(R.EOT)
        else:
            out.extend(_BYTE_ID[b] for b in mark.encode("utf-8"))
        pos = m.end()
    out.extend(_BYTE_ID[b] for b in text[pos:].encode("utf-8"))
    return out


def read_manifest(path: str):
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        rels = [ln.strip().split("\t")[0] for ln in f if ln.strip()]
    return root, rels


def label_ids(transcript: str, prev: str, rng: np.random.RandomState, ts_prob: float,
              prev_prob: float, max_len: int) -> List[int]:
    ids = [R.SOT, ZH, TRANSCRIBE] + encode(transcript) + [R.EOT]
    has_ts = any(t >= R.TS_BEGIN for t in ids)
    predict = True
    if has_ts:
        predict = bool(rng.binomial(1, ts_prob))
        if not predict:
            ids = [t for t in ids if t < R.TS_BEGIN]
            ids.insert(3, R.NO_TIMESTAMPS)
    prompt = None
    if prev and len(prev) > len("<|startofprev|>") and bool(rng.binomial(1, prev_prob)):
        prompt = encode(prev)
    if prompt is not None:
        if has_ts and not predict:
            prompt = [t if t < R.TS_BEGIN else SPACE for t in prompt]
        cut = max_len // 2
        if len(prompt) > cut:
            prompt = [SOT_PREV] + prompt[-cut + 1:]
        if len(prompt) + len(ids) > max_len:
            trim = len(prompt) + len(ids) - max_len + 1
            prompt = [SOT_PREV] + prompt[trim:]
        ids = prompt + ids
    return ids[:max_len]


def rows(manifest: str, seed: int, ts_prob: float, prev_prob: float, max_len: int,
         chunk: int) -> Iterator[tuple]:
    """(audio [chunk] float32, label ids) of each row of the first epoch."""
    root, rels = read_manifest(manifest)
    rng = np.random.RandomState(seed)
    order = np.arange(len(rels))
    rng.shuffle(order)
    for i in order:
        base = os.path.join(root, rels[i])
        audio = synth.read_wav(base).astype(np.float32) / 32768.0
        with open(os.path.splitext(base)[0] + ".txt", encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f.readlines()]
        text = lines[0].strip().split("<|endoftext|>")[0]
        prev = "<|startofprev|>" + (lines[1].strip() if len(lines) > 1 else "").split(
            "<|endoftext|>")[0]
        if "<|continued|>" in prev:
            stamps = TS_RE.findall(prev)
            if len(stamps) > 1:
                prev = prev.split(stamps[-1])[0] + stamps[-1]
            prev = prev.replace("<|continued|>", "")
        stamps = TS_RE.findall(text)
        if len(stamps) > 1:
            text = text.split(stamps[-1])[0] + stamps[-1]
            cut = int(float(stamps[-1][2:-2]) * 16000)
            if cut < len(audio):
                audio = audio[:cut]
        ids = label_ids(text, prev, rng, ts_prob, prev_prob, max_len)
        padded = np.zeros(chunk, np.float32)
        padded[:min(len(audio), chunk)] = audio[:chunk]
        yield padded, ids


def collate(audio: List[np.ndarray], labels: List[List[int]], max_len: int) -> dict:
    b = len(labels)
    padded = np.full((b, max_len), R.EOT, np.int64)
    keep = np.zeros((b, max_len), bool)
    for i, ids in enumerate(labels):
        padded[i, :len(ids)] = ids
        keep[i, :len(ids)] = True
    dec_in = padded[:, :-1]
    lab = np.where(keep[:, 1:], padded[:, 1:], IGNORE)
    for i in range(b):
        hits = np.flatnonzero(lab[i] == R.SOT)
        if len(hits):
            start = hits[0] + 1 if hits[0] > 0 else 0
            lab[i, :start] = IGNORE
    return {"audio": np.stack(audio), "decoder_input_ids": dec_in, "labels": lab}


def batches(manifest: str, *, seed: int, batch_size: int, n: int, ts_prob: float,
            prev_prob: float, max_len: int = 448, chunk: int = 480000) -> List[dict]:
    """The first ``n`` batches of the first epoch."""
    out, buf_a, buf_l = [], [], []
    for a, ids in rows(manifest, seed, ts_prob, prev_prob, max_len, chunk):
        buf_a.append(a)
        buf_l.append(ids)
        if len(buf_a) == batch_size:
            out.append(collate(buf_a, buf_l, max_len))
            buf_a, buf_l = [], []
            if len(out) == n:
                break
    return out
