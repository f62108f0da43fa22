"""Plain reference of the labelling front end: which 30 s chunks a corpus
of lectures gives, and the fingerprint that names a chunk.

* Spectral VAD (the published design of the labelling path): per 1 s
  block at a 0.25 s hop, the share of the sub-band log-energy envelope's
  modulation power in 2-8 Hz, the median spectral flatness over
  200-6800 Hz and the mean frame energy, over 25 ms Hann frames at 10 ms.
  Files are scored in 120 s segments laid end to end in corpus order, each
  file padded to whole segments, in device groups of 16 segments; a
  segment's last frame reads 240 samples past its end (the next file's
  first samples, or zeros at a group boundary and after the last file).
  Scores are computed in float64 here; the hysteresis (enter after 3
  blocks at modulation >= 0.50 with energy above the adaptive floor and
  flatness <= 0.30, leave below 0.44) and the region smoothing follow.
* Chunks: each region in 30 s windows with 5 s strides on both sides.
* A chunk's fingerprint is the exact integer sum of its int16 samples
  (zero past the chunk's valid length) against seeded weights below 2**12,
  which float64 holds exactly in any order of summation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

SR = 16000
SEG = 120 * SR
WIN, HOP, N_FFT = 400, 160, 512
FPB, BLOCK_HOP = 100, 25
SEG_FRAMES = SEG // HOP
SEG_BLOCKS = (SEG_FRAMES - FPB) // BLOCK_HOP + 1
GROUP_SEGS = 16
N_BANDS = 16

# hysteresis and smoothing (the labelling default)
ENTER, EXIT, CONFIRM, FLAT_MAX = 0.50, 0.44, 3, 0.30
ENTER_DB, FLOOR_PCT, ABS_FLOOR_DB, ABS_SPEECH_DB = 6.0, 10.0, -65.0, -40.0
MIN_SPEECH_S, MIN_SILENCE_S, PAD_S, BLOCK_S, HOP_S = 0.3, 0.5, 0.25, 1.0, 0.25


def _tables(device):
    freqs = np.fft.rfftfreq(N_FFT, 1.0 / SR)
    band = np.flatnonzero((freqs >= 200) & (freqs <= 6800))
    lo, hi = int(band[0]), int(band[-1]) + 1
    edges = np.linspace(0, hi - lo, N_BANDS + 1).astype(int)
    env = np.zeros((hi - lo, N_BANDS))
    for b in range(N_BANDS):
        env[edges[b]:edges[b + 1], b] = 1.0 / (edges[b + 1] - edges[b])
    mf = np.fft.rfftfreq(FPB, HOP / SR)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    return dict(window=t(np.hanning(WIN)), env=t(env), lo=lo, hi=hi,
                syl=t((mf >= 2) & (mf <= 8)), tot=t((mf >= 0.5) & (mf <= 25)))


def score_segments(segs: torch.Tensor, tab: dict) -> np.ndarray:
    """[K, SEG + WIN] int16 -> [K, 3, SEG_BLOCKS] (energy dB, flatness,
    modulation ratio), float64."""
    eps = 1e-10
    x = segs.double() / 32768.0
    frames = x.unfold(1, WIN, HOP)[:, :SEG_FRAMES] * tab["window"]
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    p = spec.real ** 2 + spec.imag ** 2
    energy = 10.0 * torch.log10(p.mean(-1) + eps)
    pb = p[..., tab["lo"]:tab["hi"]]
    flat = torch.exp(torch.log(pb + eps).mean(-1)) / (pb.mean(-1) + eps)
    env = torch.log(pb @ tab["env"] + eps)
    eb = env.unfold(1, FPB, BLOCK_HOP)
    eb = eb - eb.mean(-1, keepdim=True)
    mod = torch.fft.rfft(eb, dim=-1).abs() ** 2
    ratio = (mod * tab["syl"]).sum((-2, -1)) / ((mod * tab["tot"]).sum((-2, -1)) + eps)
    srt = flat.unfold(1, FPB, BLOCK_HOP).sort(-1).values
    flat_b = (srt[..., FPB // 2 - 1] + srt[..., FPB // 2]) * 0.5
    e_b = energy.unfold(1, FPB, BLOCK_HOP).mean(-1)
    return torch.stack([e_b, flat_b, ratio], 1).cpu().numpy()


def _smooth(spans, total_s):
    out = []
    for a, b in spans:
        a, b = max(a - PAD_S, 0.0), min(b + PAD_S, total_s)
        if b - a < MIN_SPEECH_S:
            continue
        if out and a - out[-1][1] < MIN_SILENCE_S:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def regions_from_scores(raw: np.ndarray, total_s: float) -> List[Tuple[float, float]]:
    """Hysteresis and smoothing over one file's [n_seg, 3, nb] scores."""
    if total_s <= 0:
        return []
    t, e, f, m = [], [], [], []
    for s in range(raw.shape[0]):
        ts = s * 120 + np.arange(raw.shape[2]) * HOP_S
        keep = ts < total_s
        t.append(ts[keep])
        e.append(raw[s, 0][keep])
        f.append(raw[s, 1][keep])
        m.append(raw[s, 2][keep])
    t, e, f, m = (np.concatenate(v) for v in (t, e, f, m))
    floor = float(np.percentile(e, FLOOR_PCT))
    enter = max(min(floor + ENTER_DB, ABS_SPEECH_DB), ABS_FLOOR_DB)
    ok_all = (e > enter) & (f <= FLAT_MAX)
    spans, inside, start, run = [], False, 0.0, 0
    for i in range(len(t)):
        ok = bool(ok_all[i])
        if not inside:
            if ok and m[i] >= ENTER:
                run += 1
                if run >= CONFIRM:
                    inside, start = True, float(t[i - run + 1])
            else:
                run = 0
        else:
            run = 0
            if not ok or m[i] < EXIT:
                spans.append((start, float(t[i]) + HOP_S))
                inside = False
    if inside:
        spans.append((start, total_s))
    spans = [(a, min(b + BLOCK_S - HOP_S, total_s)) for a, b in spans]
    return _smooth(spans, total_s)


def corpus_regions(files: Sequence[np.ndarray], device) -> List[List[Tuple[float, float]]]:
    """Regions of every file (int16 arrays in corpus order) under the
    stream layout of the module docstring."""
    tab = _tables(device)
    l_stream = GROUP_SEGS * SEG
    bases, base = [], 0
    for a in files:
        bases.append(base)
        base += max(-(-len(a) // SEG), 1) * SEG
    out = []
    for i, a in enumerate(files):
        n_seg = max(-(-len(a) // SEG), 1)
        padded = np.zeros(n_seg * SEG + WIN, np.int16)
        padded[:len(a)] = a
        seg_end = bases[i] + n_seg * SEG
        if i + 1 < len(files) and seg_end % l_stream != 0:
            head = files[i + 1][:WIN]
            padded[n_seg * SEG: n_seg * SEG + len(head)] = head
        segs = np.stack([padded[s * SEG: s * SEG + SEG + WIN] for s in range(n_seg)])
        raw = score_segments(torch.from_numpy(segs).to(device), tab)
        out.append(regions_from_scores(raw, len(a) / SR))
    return out


def chunk_spans(span_len: int, chunk_len: int, stride: int):
    """(start, valid) of each strided window over a region of
    ``span_len`` samples."""
    out, pos = [], 0
    while True:
        start = max(pos - stride, 0) if pos > 0 else 0
        out.append((start, min(chunk_len, span_len - start)))
        if start + chunk_len >= span_len:
            return out
        pos = start + chunk_len - stride


def corpus_chunks(regions: Sequence[Sequence[Tuple[float, float]]], chunk_len: int,
                  stride: int) -> List[Tuple[int, int, int]]:
    """(file, first sample, valid samples) of every chunk, in order."""
    out = []
    for f, regs in enumerate(regions):
        for a, b in regs:
            s0 = int(a * SR)
            n = int(b * SR) - s0
            if n <= 0:
                continue
            out.extend((f, s0 + st, v) for st, v in chunk_spans(n, chunk_len, stride))
    return out


def fingerprint_weights(seed: int, n: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 4096, (n,), generator=g, dtype=torch.int64).double().to(device)


def fingerprint_i16(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, N] int16 samples -> [B] int64."""
    return (rows.double() @ w).round().long()


def chunk_rows(files: Sequence[np.ndarray], chunks: Sequence[Tuple[int, int, int]],
               chunk_len: int) -> np.ndarray:
    """[len(chunks), chunk_len] int16 rows, zero past each valid length."""
    out = np.zeros((len(chunks), chunk_len), np.int16)
    for j, (f, s, v) in enumerate(chunks):
        out[j, :v] = files[f][s:s + v]
    return out
