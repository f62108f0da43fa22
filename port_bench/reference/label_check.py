"""The comparison that decides ``correct`` in the labelling cells.

What the window produced is read where the port produces it: for every
batch that ``label_files`` decodes, the fingerprint of each audio row it
decoded and the tokens and lengths it returned. The reference works the
rest out again from the WAV files alone:

1. ``chunks_unmatched``: its VAD regions and 30 s chunks of the corpus,
   as a multiset of fingerprints, against the rows the port decoded
   (padding rows, all zeros, left out). Exact: limit 0.
2. A seeded sample of the decoded rows, the longest among them; for each,
   the reference's log-mel, encoder and teacher-forced decoder over the
   sot prefix and the served tokens, in float32. Greedy:
   ``greedy_gap_max``, the widest ``rules.step_gaps`` of a served token.
   Greedy's summed log-probability is not compared: it jumps by some 3-4
   nats wherever the port and the reference fall on two sides of the
   rule that forces a timestamp (its normaliser is then the timestamps'
   alone), which made sound rows read as wide a gap as a fault's.
   Beam search (whose served tokens are no greedy choices):
   ``beam_logprob_gap_median``, over the rows, the median per-token gap
   between the summed log-probability the port reported for the best
   hypothesis and the reference's of the same tokens (a token altered, or
   scored from other logits, moves it). The median, and not the widest:
   the widest row of the program and of its control lay within 3x of each
   other on 12 seeds (PERF.md), the median rows do not. ``detail`` keeps
   each row's reading and how many sampled rows differ, for the readings.

The control is the same reference at fp8 (``model.Precision``): at every
position of the same rows and tokens, the token that its greedy choice
puts first, read by the same gap, and its own summed log-probability of
the served tokens in the port's place (``control=True``).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..harness import Check
from . import audio as A
from . import rules as R
from .model import Precision, Whisper, encode_blocks, log_mel, strict_fp32

DECODE_ROWS = 4


def sample_rows(lengths: np.ndarray, n: int, rng: np.random.RandomState) -> List[int]:
    """``n`` row indices drawn from the seed, the longest row first."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in pick]


def row_readings(ref: Whisper, ctl, rows_i16: np.ndarray, prefix: Sequence[int],
                 served: Sequence[np.ndarray], prog_sums: Sequence[float], beams: int,
                 device) -> List[dict]:
    """Per row, what the reference reads of the served tokens: greedy's
    logit gap of each, or under beam search the gap between the summed
    log-probability the port reported and the reference's, per token. With
    ``ctl`` (the control in the port's place) the tokens it would put
    first, or its own summed log-probability, are read instead."""
    cfg = ref.cfg
    out: List[dict] = []
    p = len(prefix)
    for r in range(0, len(served), DECODE_ROWS):
        block = served[r:r + DECODE_ROWS]
        audio = torch.from_numpy(rows_i16[r:r + DECODE_ROWS]).to(device).double() / 32768.0
        mel = log_mel(audio, cfg["num_mel_bins"])
        n_max = max(len(s) for s in block)
        seq = np.full((len(block), p + n_max - 1), R.EOT, np.int64)
        for j, s in enumerate(block):
            full = list(prefix) + list(s)
            seq[j, :len(full) - 1] = full[:-1]
        seq_t = torch.from_numpy(seq).to(device)
        with torch.no_grad():
            logits = ref.decode(encode_blocks(ref, mel), seq_t)[:, p - 1:]
            c_logits = (ctl.decode(encode_blocks(ctl, mel), seq_t)[:, p - 1:]
                        if ctl is not None else None)
        for j, s in enumerate(block):
            n = len(s)
            masks = R.rule_masks(prefix, s, logits.shape[-1], device)
            toks = torch.from_numpy(np.asarray(s)).to(device)
            if beams <= 1:
                if c_logits is not None:
                    toks = R.greedy_picks(c_logits[j, :n], masks)
                out.append({"gap": float(R.step_gaps(logits[j, :n], masks, toks).max())})
                continue
            ref_sum = float(R.beam_logprobs(logits[j, :n], masks).gather(-1, toks[:, None]).sum())
            if c_logits is not None:
                got = float(R.beam_logprobs(c_logits[j, :n], masks).gather(-1, toks[:, None]).sum())
            else:
                got = float(prog_sums[r + j])
            out.append({"logprob_gap": abs(got - ref_sum) / n})
        del logits, c_logits
    return out


def check(*, weights: Dict[str, torch.Tensor], cfg: dict, files: Sequence[np.ndarray],
          batches: Sequence[dict], prefix: Sequence[int], chunk_len: int, stride: int,
          fp_seed: int, sample: int, rng: np.random.RandomState, limits: dict, device,
          beams: int = 1, control: bool = False) -> List[Check]:
    """``batches``: per decoded batch {"fp": [B] int64, "tokens": [B, L],
    "lengths": [B], "sum_logprobs": [B]} as numpy; ``beams`` the beam width
    (1: greedy)."""
    strict_fp32()
    regions = A.corpus_regions(files, device)
    chunks = A.corpus_chunks(regions, chunk_len, stride)
    w = A.fingerprint_weights(fp_seed, chunk_len, device)
    ref_rows = A.chunk_rows(files, chunks, chunk_len)
    ref_fp = np.concatenate([
        A.fingerprint_i16(torch.from_numpy(ref_rows[i:i + 64]).to(device), w).cpu().numpy()
        for i in range(0, len(ref_rows), 64)]) if len(ref_rows) else np.zeros(0, np.int64)
    by_fp = {int(f): j for j, f in enumerate(ref_fp)}

    prog_fp, prog_tok, prog_len, prog_sum = [], [], [], []
    for b in batches:
        for j, f in enumerate(b["fp"]):
            if int(f) != 0:
                prog_fp.append(int(f))
                prog_tok.append(b["tokens"][j])
                prog_len.append(int(b["lengths"][j]))
                prog_sum.append(float(b["sum_logprobs"][j]))
    want, got = Counter(int(f) for f in ref_fp), Counter(prog_fp)
    unmatched = sum(((want - got) + (got - want)).values())
    checks = [Check("chunks_unmatched", float(unmatched), float(limits["chunks_unmatched"]),
                    unmatched)]

    rows = [i for i in sample_rows(np.asarray(prog_len), sample, rng) if prog_fp[i] in by_fp]
    p = len(prefix)
    served = [R.served_tokens(prog_tok[i], p, prog_len[i]) for i in rows]
    rows_i16 = np.stack([ref_rows[by_fp[prog_fp[i]]] for i in rows]) if rows else \
        np.zeros((0, chunk_len), np.int16)
    ref = Whisper(weights, cfg)
    ctl = Whisper(weights, cfg, Precision("fp8")) if control else None
    reads = row_readings(ref, ctl, rows_i16, prefix, served, [prog_sum[i] for i in rows],
                         beams, device)
    keys = {"gap": "greedy_gap_max"} if beams <= 1 else {"logprob_gap": "beam_logprob_gap_median"}
    distinct = len({tuple(int(t) for t in s) for s in served})
    for key, name in keys.items():
        vals = [r[key] for r in reads]
        stat = float(np.median(vals)) if name.endswith("_median") and vals else \
            max(vals, default=float("inf"))
        checks.append(Check(name, stat, float(limits[name]),
                            sum(v > limits[name] for v in vals),
                            detail=dict(rows=len(vals), distinct_rows=distinct,
                                        per_row=[round(float(v), 5) for v in vals])))
    return checks
