"""Voice activity detection: spectral speech/music/noise gate + energy VAD
(port of taiwan_whisper_tpu/pipeline/vad.py).

* **Spectral VAD** (the labelling default): per 1 s block at 0.25 s hop,
  the syllabic modulation ratio (share of the sub-band log-energy
  envelope's modulation spectrum in 2-8 Hz; speech is modulated at
  syllable rate, music and steady noise are not), the spectral flatness
  over 200-6800 Hz (broadband noise is flat, voiced speech harmonic) and
  the block energy; hysteresis on the ratio, gated by flatness and an
  adaptive energy floor, gives regions. The scores come from numpy
  (``spectral_block_scores``, the host scorer) or from PyTorch on a
  device (``_device_scorer``, fixed 120 s int16 segments, eight a call);
  the hysteresis always runs on the host.
* **Energy VAD** (``speech_regions``): frame RMS with an adaptive noise
  floor and hysteresis.

The numpy code is the JAX package's, verbatim. The device scorer is its
XLA scorer in PyTorch: ``torch.fft.rfft``, a matmul with the sub-band
averaging matrix and reductions, on the device its input lies on.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000


@dataclasses.dataclass
class VadConfig:
    frame_ms: float = 20.0
    # hysteresis: enter speech above `high`, leave below `low` (relative to
    # the adaptive noise floor, in dB)
    enter_db_above_floor: float = 9.0
    exit_db_above_floor: float = 6.0
    floor_percentile: float = 10.0
    min_speech_s: float = 0.25
    min_silence_s: float = 0.5
    pad_s: float = 0.2  # margin added around each region
    abs_floor_db: float = -60.0  # absolute silence level (dBFS)
    abs_speech_db: float = -35.0  # anything above this is speech regardless
    # of the adaptive floor (handles continuously-voiced audio where the
    # "noise floor" percentile lands on speech itself)


def frame_energies_db(audio: np.ndarray, cfg: VadConfig) -> np.ndarray:
    hop = int(SAMPLE_RATE * cfg.frame_ms / 1000.0)
    n = (len(audio) // hop) * hop
    if n == 0:
        return np.full((1,), -120.0, np.float32)
    frames = audio[:n].reshape(-1, hop)
    rms = np.sqrt(np.mean(np.square(frames.astype(np.float64)), axis=1) + 1e-12)
    return (20.0 * np.log10(rms + 1e-12)).astype(np.float32)


def speech_regions(
    audio: np.ndarray, cfg: VadConfig = VadConfig()
) -> List[Tuple[float, float]]:
    """(start_s, end_s) speech regions, padded and smoothed."""
    e = frame_energies_db(audio, cfg)
    hop_s = cfg.frame_ms / 1000.0
    floor = max(float(np.percentile(e, cfg.floor_percentile)), cfg.abs_floor_db - 20.0)
    enter = max(min(floor + cfg.enter_db_above_floor, cfg.abs_speech_db),
                cfg.abs_floor_db)
    exit_ = max(min(floor + cfg.exit_db_above_floor, cfg.abs_speech_db - 3.0),
                cfg.abs_floor_db)

    regions: List[Tuple[int, int]] = []
    in_speech = False
    start = 0
    silence_run = 0
    min_sil_frames = int(cfg.min_silence_s / hop_s)
    for i, db in enumerate(e):
        if not in_speech:
            if db > enter:
                in_speech = True
                start = i
                silence_run = 0
        else:
            if db < exit_:
                silence_run += 1
                if silence_run >= min_sil_frames:
                    regions.append((start, i - silence_run + 1))
                    in_speech = False
            else:
                silence_run = 0
    if in_speech:
        regions.append((start, len(e)))

    total_s = len(audio) / SAMPLE_RATE
    spans = [(s * hop_s, t * hop_s) for s, t in regions]
    return _smooth_regions(spans, total_s, cfg.pad_s, cfg.min_speech_s,
                           cfg.min_silence_s)


def _smooth_regions(
    spans: List[Tuple[float, float]],
    total_s: float,
    pad_s: float,
    min_speech_s: float,
    min_silence_s: float,
) -> List[Tuple[float, float]]:
    """Pad each raw (start_s, end_s) span, merge near neighbours, drop
    too-short regions."""
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        a = max(a - pad_s, 0.0)
        b = min(b + pad_s, total_s)
        if b - a < min_speech_s:
            continue
        if out and a - out[-1][1] < min_silence_s:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def speech_ratio(audio: np.ndarray, cfg: VadConfig = VadConfig()) -> float:
    regions = speech_regions(audio, cfg)
    total = len(audio) / SAMPLE_RATE
    if total <= 0:
        return 0.0
    return sum(b - a for a, b in regions) / total


def extract_speech(
    audio: np.ndarray, cfg: VadConfig = VadConfig()
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Concatenate speech regions; returns (speech audio, original regions)
    so downstream timestamps can be mapped back."""
    regions = speech_regions(audio, cfg)
    if not regions:
        return np.zeros((0,), np.float32), []
    parts = [
        audio[int(a * SAMPLE_RATE) : int(b * SAMPLE_RATE)] for a, b in regions
    ]
    return np.concatenate(parts).astype(np.float32), regions


# ---------------------------------------------------------------------------
# Spectral VAD (speech vs music vs noise)
# ---------------------------------------------------------------------------

_N_FFT, _WIN, _HOP = 512, 400, 160  # 25 ms window / 10 ms hop @ 16 kHz
_N_ENV_BANDS = 16


@dataclasses.dataclass
class SpectralVadConfig:
    """Thresholds calibrated on synthetic fixtures (module docstring):
    speech sits at mod_ratio >= 0.61 even under pink noise; sustained music
    <= 0.38; broadband noise flatness >= 0.39 vs <= 0.18 for speech."""

    block_s: float = 1.0
    hop_s: float = 0.25
    mod_ratio_enter: float = 0.50
    mod_ratio_exit: float = 0.44
    # speech is confirmed only after this many consecutive blocks pass the
    # enter test: music onsets (chord attacks) produce isolated blocks above
    # mod_ratio_enter but never sustained runs
    confirm_blocks: int = 3
    flatness_max: float = 0.30
    # energy gates: adaptive floor like the energy VAD plus an absolute one;
    # abs_speech_db caps the adaptive threshold so continuously-voiced audio
    # (no silence for the floor percentile to land on) still passes
    enter_db_above_floor: float = 6.0
    floor_percentile: float = 10.0
    abs_floor_db: float = -65.0
    abs_speech_db: float = -40.0
    min_speech_s: float = 0.3
    min_silence_s: float = 0.5
    pad_s: float = 0.25


def _spectral_frame_features(
    audio: np.ndarray, chunk_frames: int = 8192
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One STFT pass in bounded memory -> per-frame (energy_db [T],
    flatness [T], env [T, 16]): flatness over the 200-6800 Hz speech band,
    env = log energy in 16 equal sub-bands of that band (the modulation
    carrier)."""
    audio = np.asarray(audio, np.float32)
    n_frames = max(1 + (len(audio) - _WIN) // _HOP, 1)
    window = np.hanning(_WIN).astype(np.float32)
    freqs = np.fft.rfftfreq(_N_FFT, 1.0 / SAMPLE_RATE)
    band = np.flatnonzero((freqs >= 200) & (freqs <= 6800))
    edges = np.linspace(0, len(band), _N_ENV_BANDS + 1).astype(int)
    eps = 1e-10

    energy_db = np.empty(n_frames, np.float32)
    flatness = np.empty(n_frames, np.float32)
    env = np.empty((n_frames, _N_ENV_BANDS), np.float32)
    for s in range(0, n_frames, chunk_frames):
        e = min(s + chunk_frames, n_frames)
        idx = s * _HOP + np.arange(e - s)[:, None] * _HOP + np.arange(_WIN)
        frames = np.zeros((e - s, _WIN), np.float32)
        valid = np.minimum(idx, len(audio) - 1)
        frames = np.where(idx < len(audio), audio[valid], 0.0)
        spec = np.fft.rfft(frames * window, _N_FFT, axis=1)
        p = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
        energy_db[s:e] = 10.0 * np.log10(p.mean(1) + eps)
        pb = p[:, band]
        flatness[s:e] = np.exp(np.mean(np.log(pb + eps), 1)) / (pb.mean(1) + eps)
        for b in range(_N_ENV_BANDS):
            env[s:e, b] = np.log(pb[:, edges[b]:edges[b + 1]].mean(1) + eps)
    return energy_db, flatness, env


def spectral_block_scores(
    audio: np.ndarray, cfg: SpectralVadConfig = SpectralVadConfig()
) -> dict:
    """Per-block diagnostics: {"t", "mod_ratio", "flatness", "energy_db"}
    (numpy arrays, one entry per cfg.hop_s starting at t)."""
    energy_db, flatness, env = _spectral_frame_features(audio)
    T = env.shape[0]
    fpb = max(int(cfg.block_s * SAMPLE_RATE / _HOP), 4)
    hop = max(int(cfg.hop_s * SAMPLE_RATE / _HOP), 1)
    fpb = min(fpb, T)
    n_blocks = max((T - fpb) // hop + 1, 1)

    def blocked(x):  # [T, ...] -> [NB, fpb, ...] strided view
        shape = (n_blocks, fpb) + x.shape[1:]
        strides = (x.strides[0] * hop,) + x.strides
        return np.lib.stride_tricks.as_strided(x, shape, strides)

    env_b = blocked(env)  # [NB, fpb, 16]
    env_b = env_b - env_b.mean(axis=1, keepdims=True)
    mod = np.abs(np.fft.rfft(env_b, axis=1)) ** 2  # [NB, F, 16]
    mf = np.fft.rfftfreq(fpb, _HOP / SAMPLE_RATE)
    syl = mod[:, (mf >= 2) & (mf <= 8)].sum(axis=(1, 2))
    tot = mod[:, (mf >= 0.5) & (mf <= 25)].sum(axis=(1, 2)) + 1e-10
    return {
        "t": np.arange(n_blocks) * hop * _HOP / SAMPLE_RATE,
        "mod_ratio": (syl / tot).astype(np.float32),
        "flatness": np.median(blocked(flatness), axis=1),
        "energy_db": blocked(energy_db).mean(axis=1),
    }


def spectral_speech_regions(
    audio: np.ndarray, cfg: SpectralVadConfig = SpectralVadConfig(),
    scores: dict = None,
) -> List[Tuple[float, float]]:
    """(start_s, end_s) speech regions; music/steady-noise blocks rejected.

    ``scores`` injects precomputed block scores (e.g. the device scorer,
    spectral_block_scores_device) — hysteresis/smoothing stay on host."""
    total_s = len(audio) / SAMPLE_RATE
    if total_s <= 0:
        return []
    sc = scores if scores is not None else spectral_block_scores(audio, cfg)
    floor = float(np.percentile(sc["energy_db"], cfg.floor_percentile))
    enter = max(min(floor + cfg.enter_db_above_floor, cfg.abs_speech_db),
                cfg.abs_floor_db)
    energy_ok = sc["energy_db"] > enter
    tonal = sc["flatness"] <= cfg.flatness_max

    spans: List[Tuple[float, float]] = []
    in_speech = False
    start = 0.0
    enter_run = 0
    for i, t in enumerate(sc["t"]):
        mod = sc["mod_ratio"][i]
        ok = bool(energy_ok[i] and tonal[i])
        if not in_speech:
            if ok and mod >= cfg.mod_ratio_enter:
                enter_run += 1
                if enter_run >= cfg.confirm_blocks:
                    in_speech = True
                    start = float(sc["t"][i - enter_run + 1])
            else:
                enter_run = 0
        else:
            enter_run = 0
            if not ok or mod < cfg.mod_ratio_exit:
                spans.append((start, float(t) + cfg.hop_s))
                in_speech = False
    if in_speech:
        spans.append((start, total_s))
    # a block covers [t, t + block_s); extend each span to block end
    spans = [(a, min(b + cfg.block_s - cfg.hop_s, total_s)) for a, b in spans]
    return _smooth_regions(spans, total_s, cfg.pad_s, cfg.min_speech_s,
                           cfg.min_silence_s)


# ---------------------------------------------------------------------------
# Device spectral scorer (PyTorch)
# ---------------------------------------------------------------------------

# fixed scoring segment: files are scored in 120 s pieces (blocks spanning
# a piece boundary are dropped, ~0.6% of blocks; the hysteresis absorbs
# the edge)
_VAD_SEG_S = 120
_VAD_SEG_SAMPLES = _VAD_SEG_S * SAMPLE_RATE
# segments per scorer call: several files' segments share one call and one
# result copy to the host
_VAD_CALL_SEGS = 8
# block geometry of a segment at the default SpectralVadConfig: 100 frames
# a block, 25 frames between blocks, 12000 frames, 477 blocks
_FPB = max(int(SpectralVadConfig.block_s * SAMPLE_RATE / _HOP), 4)
_BLOCK_HOP = max(int(SpectralVadConfig.hop_s * SAMPLE_RATE / _HOP), 1)
_SEG_FRAMES = _VAD_SEG_SAMPLES // _HOP
_SEG_BLOCKS = (_SEG_FRAMES - _FPB) // _BLOCK_HOP + 1


@dataclasses.dataclass
class DeviceScorer:
    """The per-segment scorer's constants, resident on one device.
    ``__call__`` maps [K, SEG + WIN] int16 (or fp32) segments on that
    device to [K, 3, nb] fp32 scores (energy_db, flatness, mod_ratio)."""

    window: torch.Tensor  # [WIN] np.hanning: the symmetric window
    env_mat: torch.Tensor  # [hi - lo, 16] sub-band averaging
    syl_mask: torch.Tensor  # [fpb // 2 + 1] 2-8 Hz modulation bins
    tot_mask: torch.Tensor  # [fpb // 2 + 1] 0.5-25 Hz modulation bins
    lo: int
    hi: int

    def __call__(self, segs: torch.Tensor) -> torch.Tensor:
        eps = 1e-10
        if segs.dtype == torch.int16:  # int16 wire: half the upload bytes
            segs = segs.float() / 32768.0
        # [K, SEG + WIN] -> [K, 12000, WIN]; unfold gives one frame more
        frames = segs.unfold(1, _WIN, _HOP)[:, :_SEG_FRAMES] * self.window
        spec = torch.fft.rfft(frames, n=_N_FFT, dim=-1)
        p = spec.real ** 2 + spec.imag ** 2  # [K, n_frames, 257]
        energy_db = 10.0 * torch.log10(p.mean(-1) + eps)
        pb = p[..., self.lo: self.hi]
        flatness = torch.exp(torch.log(pb + eps).mean(-1)) / (pb.mean(-1) + eps)
        env = torch.log(pb @ self.env_mat + eps)  # [K, n_frames, 16]
        env_b = env.unfold(1, _FPB, _BLOCK_HOP)  # [K, nb, 16, fpb]
        env_b = env_b - env_b.mean(-1, keepdim=True)
        mod = torch.fft.rfft(env_b, dim=-1).abs() ** 2  # [K, nb, 16, F]
        syl = (mod * self.syl_mask).sum((-2, -1))
        tot = (mod * self.tot_mask).sum((-2, -1)) + eps
        flat_b = block_median(flatness)
        e_b = energy_db.unfold(1, _FPB, _BLOCK_HOP).mean(-1)
        return torch.stack([e_b, flat_b, syl / tot], dim=1)


def block_median(x: torch.Tensor) -> torch.Tensor:
    """[K, n_frames] -> [K, nb] median over each block's _FPB frames. The
    median of an even count is the mean of the middle two, as numpy and jnp
    take it (torch.median returns the lower one)."""
    s = x.unfold(1, _FPB, _BLOCK_HOP).sort(-1).values
    return (s[..., _FPB // 2 - 1] + s[..., _FPB // 2]) * 0.5


_scorer_cache: dict = {}  # torch.device -> DeviceScorer


def _device_scorer(device) -> DeviceScorer:
    """The scorer for ``device``, built on first use and cached by device."""
    dev = torch.device(device)
    if dev not in _scorer_cache:
        _scorer_cache[dev] = _build_scorer(dev)
    return _scorer_cache[dev]


def _build_scorer(device) -> DeviceScorer:
    freqs = np.fft.rfftfreq(_N_FFT, 1.0 / SAMPLE_RATE)
    band = np.flatnonzero((freqs >= 200) & (freqs <= 6800))
    lo, hi = int(band[0]), int(band[-1]) + 1  # contiguous
    edges = np.linspace(0, hi - lo, _N_ENV_BANDS + 1).astype(int)
    env_mat = np.zeros((hi - lo, _N_ENV_BANDS), np.float32)
    for b in range(_N_ENV_BANDS):
        env_mat[edges[b]: edges[b + 1], b] = 1.0 / (edges[b + 1] - edges[b])
    mf = np.fft.rfftfreq(_FPB, _HOP / SAMPLE_RATE)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return DeviceScorer(
        window=put(np.hanning(_WIN)), env_mat=put(env_mat),
        syl_mask=put((mf >= 2) & (mf <= 8)), tot_mask=put((mf >= 0.5) & (mf <= 25)),
        lo=lo, hi=hi)


def _score_segments(seg_batch: np.ndarray, device) -> np.ndarray:
    """[K, SEG+WIN] i16 -> [K, 3, nb] numpy, scored on ``device`` in calls
    of _VAD_CALL_SEGS segments (K padded with zero segments)."""
    score = _device_scorer(device)
    k = seg_batch.shape[0]
    pad = (-k) % _VAD_CALL_SEGS
    if pad:
        seg_batch = np.concatenate(
            [seg_batch,
             np.zeros((pad,) + seg_batch.shape[1:], seg_batch.dtype)]
        )
    outs = []
    with torch.inference_mode():
        for s in range(0, seg_batch.shape[0], _VAD_CALL_SEGS):
            segs = torch.from_numpy(seg_batch[s: s + _VAD_CALL_SEGS]).to(device)
            outs.append(score(segs).cpu().numpy())
    return np.concatenate(outs)[:k]


def _file_segments(audio: np.ndarray) -> np.ndarray:
    """Pad + slice one file into [n_seg, SEG+WIN] int16 scoring segments.

    int16 wire: both the batched and per-file device scorers quantize the
    SAME way, so their scores are bit-identical; quantization noise on the
    features is ~1e-4, far below the hysteresis thresholds."""
    n_seg = max(-(-len(audio) // _VAD_SEG_SAMPLES), 1)
    i16 = np.clip(np.round(audio.astype(np.float32) * 32768.0),
                  -32768, 32767).astype(np.int16)
    padded = np.zeros(n_seg * _VAD_SEG_SAMPLES + _WIN, np.int16)
    padded[: len(i16)] = i16
    return np.stack([
        padded[s * _VAD_SEG_SAMPLES: (s + 1) * _VAD_SEG_SAMPLES + _WIN]
        for s in range(n_seg)
    ])


def _scores_dict(raw: np.ndarray, total_s: float) -> dict:
    """[n_seg, 3, nb] -> score dict, zero-pad tail blocks trimmed so they
    cannot drag the adaptive energy floor."""
    nb = raw.shape[2]
    hop_s = _BLOCK_HOP * _HOP / SAMPLE_RATE
    ts, es, fs, ms = [], [], [], []
    for s in range(raw.shape[0]):
        t = s * _VAD_SEG_S + np.arange(nb) * hop_s
        keep = t < total_s
        ts.append(t[keep])
        es.append(raw[s, 0][keep])
        fs.append(raw[s, 1][keep])
        ms.append(raw[s, 2][keep])
    return {
        "t": np.concatenate(ts),
        "energy_db": np.concatenate(es),
        "flatness": np.concatenate(fs),
        "mod_ratio": np.concatenate(ms),
    }


def spectral_block_scores_device(audio: np.ndarray, device) -> dict:
    """Per-block scores computed on ``device``; same dict contract as
    spectral_block_scores (default SpectralVadConfig only)."""
    segs = _file_segments(audio)
    return _scores_dict(_score_segments(segs, device), len(audio) / SAMPLE_RATE)


def spectral_regions_device_batch(
    audios: "List[np.ndarray]", device,
) -> "List[List[Tuple[float, float]]]":
    """Speech regions for MANY files with few scorer calls: all files'
    scoring segments are concatenated into _VAD_CALL_SEGS-sized calls on
    ``device`` (one result copy each); hysteresis runs per file on host.
    The batch entry point the pooled labelling driver feeds."""
    if not audios:
        return []
    seg_groups = [_file_segments(a) for a in audios]
    counts = [g.shape[0] for g in seg_groups]
    raw = _score_segments(np.concatenate(seg_groups), device)
    out = []
    pos = 0
    for audio, n in zip(audios, counts):
        total_s = len(audio) / SAMPLE_RATE
        sc = _scores_dict(raw[pos: pos + n], total_s)
        out.append(spectral_speech_regions(audio, scores=sc))
        pos += n
    return out


def resolve_vad_mode(mode: str, device) -> str:
    """"spectral" computes the scores on ``device`` when it is a CUDA
    device and with numpy elsewhere; the -device/-host suffixes force
    one."""
    if mode != "spectral":
        return mode
    return "spectral-device" if torch.device(device).type == "cuda" else "spectral-host"


def detect_speech_regions(
    audio: np.ndarray, mode: str = "spectral", device="cuda"
) -> List[Tuple[float, float]]:
    """Unified entry for the labelling driver: mode in {"spectral",
    "spectral-device", "spectral-host", "energy", "off"} ("off" -> whole
    file is one region); the device scorer runs on ``device``."""
    mode = resolve_vad_mode(mode, device)
    if mode == "spectral-device":
        return spectral_speech_regions(
            audio, scores=spectral_block_scores_device(audio, device)
        )
    if mode == "spectral-host":
        return spectral_speech_regions(audio)
    if mode == "energy":
        return speech_regions(audio)
    if mode == "off":
        return [(0.0, len(audio) / SAMPLE_RATE)] if len(audio) else []
    raise ValueError(f"unknown vad mode {mode!r}")
