"""Stage 1: pseudo-labelling — the teacher transcribes long-form audio
(port of taiwan_whisper_tpu/pipeline/label.py, chunked strategy).

``label_files`` dispatches as the JAX package's does. With ``wire_mode``
"resident", or "auto" when the VAD mode allows it (spectral or off), it
runs the device-resident driver (pipeline/label_resident.py): each file is
uploaded once as int16 into group buffers on the device, which the VAD
scorer and the 30 s chunk rows both read. Otherwise ("chunks", or energy /
host-spectral VAD) it runs the pooled chunk scheduler here: 30 s chunks of
the VAD regions of all files feed one queue and are decoded in full
``batch_size`` batches (padding rows repeat the last chunk), each batch
stacked on the wire (int16 by default) and staged ahead on a thread while
the previous one decodes. A batch is mel (kernel) -> encode -> greedy
decode, or beam search with ``num_beams`` > 1; segments scatter back
through the stride core-region merge to per-file CSVs. Spectral VAD scores
on the device go through ``spectral_regions_device_batch`` so several
files share one scorer call. ``strategy="sequential"`` and
``pooled=False`` label file by file: ``sequential_decode`` or
``chunked_decode`` over each VAD region, timestamps shifted back to the
file's timeline.

With an assistant (a draft model: ``run_labelling(assistant_dir=)``,
``cli label --assistant``) every file goes file by file through
``_speculative_chunked``: one strided 30 s window at a time, the student
drafting and the teacher verifying (decode/speculative.py), the encoder
shared when the two models' encoders have the same width and depth.

``run_labelling`` labels this process's contiguous shard of the manifest
(``parallel.host_local_slice``: all of it outside a multi-process run),
and also labels a ground-truth split when given one and scores the
pseudo-labels against it (``validate_labels``: MER, EN-WER, ZH-CER).

Each ``label_files`` call's stats carry ``spans`` and ``counts``: what the
port's spans and counters (``utils/profiling.py``) took during that call.
The pooled and resident drivers time their waits, VAD, decode and scatter
as spans that also add to the stats' seconds (``label.load_wait`` ->
``load_wait_s``, ``label.stage_wait`` / ``label.upload_wait``, ``label.vad``
-> ``vad_s``, ``label.scatter`` -> ``scatter_s``; ``label.decode``, the
batch's enqueue, and ``label.fetch``, the copy of its tokens and lengths
to the host, -> ``decode_s``), and count ``label.live_row_steps``: over the
real rows of each batch, the decode steps that served a row still
decoding, ``min(length + 1, steps)``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
import wave
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio.io import load_audio_16k
from ..audio.manifest import read_manifest
from ..audio.mel import SAMPLE_RATE
from ..decode.longform import (LongformResult, _tokens_to_segments, chunk_with_stride,
                               chunked_decode, decode_audio, sequential_decode)
from ..decode.rules import DecodeRules
from ..decode.speculative import speculative_decode
from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..models.params import prepare_params
from ..ops.mel_kernel import log_mel
from ..parallel.mesh import host_local_slice
from ..text.tokenizer import WhisperTokenizer
from ..utils import profiling
from .vad import (_VAD_CALL_SEGS, _VAD_SEG_SAMPLES, detect_speech_regions,
                  resolve_vad_mode, spectral_regions_device_batch)

# what a file that cannot be read raises: it is skipped and counted
READ_ERRORS = (OSError, EOFError, ValueError, wave.Error)


@dataclasses.dataclass
class LabelConfig:
    language: str = "zh"
    task: str = "transcribe"
    strategy: str = "chunked"  # | "sequential" (per file, temperature ladder)
    batch_size: int = 96  # device batch of pooled 30 s chunks
    # None: derive from the model context (30 s for real Whisper configs;
    # stride chunk/6, the reference's ratio)
    chunk_s: Optional[float] = None
    stride_s: Optional[float] = None
    energy_vad_threshold: float = 0.0  # 0 disables; else min RMS to transcribe
    # region-gated decode, on by default as in the reference: only detected
    # speech regions reach the teacher. "spectral" also rejects music and
    # steady noise (pipeline/vad.py; scored on the device on CUDA, with
    # numpy elsewhere); "spectral-device" / "spectral-host" force one
    # scorer; "energy" is the RMS-only gate; "off" decodes the whole file.
    vad_regions: bool = True
    vad_mode: str = "spectral"
    quantize_kv: object = False  # 0/False off; True/8 int8; 4 int4; "fp8" e4m3; "8x8"
    num_beams: int = 1  # >1: beam search (the reference labels with beam 5)
    # chunked strategy: pool chunks across VAD regions and files into full
    # device batches; False labels file by file through chunked_decode
    pooled: bool = True
    io_threads: int = 2  # host-side load + VAD prefetch workers
    # host -> device audio wire of the chunk path: "int16" is lossless for
    # PCM16 sources and half the bytes; "float32" for float-native sources
    wire_dtype: str = "int16"
    # transport: "resident" uploads each file once into device group
    # buffers that VAD and chunk rows read (pipeline/label_resident.py;
    # spectral or off VAD); "chunks" stages stacked chunk batches; "auto"
    # is resident when eligible, else chunks
    wire_mode: str = "auto"
    stage_depth: int = 2  # batches staged ahead of the decode loop
    max_decode_tokens: Optional[int] = None  # cap sampled tokens per chunk
    # resident path only: pack several short VAD regions of a file into one
    # 30 s window (pack_separator_s of silence between them) and map the
    # timestamps back piecewise. Off by default: a packed window puts
    # disjoint speech contexts side by side.
    pack_regions: bool = False
    pack_separator_s: float = 0.2
    # resident path only: 120 s segments per device group buffer (None =
    # label_resident.CAP_SEGS); smaller groups seal, and start decoding,
    # sooner
    group_segs: Optional[int] = None
    # speculative decoding, with a draft model (label_files(assistant=...),
    # cli --assistant): tokens the draft model proposes a round
    num_draft_tokens: int = 5


def energy_vad_is_speech(audio: np.ndarray, threshold: float) -> bool:
    if threshold <= 0:
        return True
    return float(np.sqrt(np.mean(np.square(audio)))) >= threshold


def write_label_csv(path: str, result: LongformResult, tok: WhisperTokenizer):
    """{start,end,text} CSV, one row per segment."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(["start", "end", "text"])
        for seg in result.segments:
            w.writerow([f"{seg.start:.3f}", f"{seg.end:.3f}", seg.text(tok)])


@dataclasses.dataclass
class _ChunkTask:
    """One padded chunk awaiting decode, tagged for scatter-back. Offsets
    are region-relative; the region start is a post-shift."""

    file_idx: int
    audio: np.ndarray  # [chunk_len] fp32, padded
    region_start: float
    offset: float
    stride_left: float
    stride_right: float
    window_duration: float  # unpadded seconds in this chunk


def _check_supported(cfg: LabelConfig):
    if cfg.strategy not in ("chunked", "sequential"):
        raise ValueError(f"strategy must be chunked or sequential, got {cfg.strategy!r}")
    if cfg.wire_dtype not in ("int16", "float32"):
        raise ValueError(f"wire_dtype must be int16 or float32, got {cfg.wire_dtype!r}")


def _file_to_tasks(file_idx: int, audio: np.ndarray, cfg: LabelConfig, chunk_s: float,
                   stride_s: float, device, regions=None) -> List[_ChunkTask]:
    """Host-side prep of one file: VAD regions -> strided chunks. Offsets
    stay region-relative; the consumer applies ``region_start`` when it
    scatters segments back. ``regions`` injects precomputed VAD regions
    (the pooled driver's batched device scorer)."""
    if regions is None:
        if cfg.vad_regions and cfg.vad_mode != "off":
            regions = detect_speech_regions(audio, cfg.vad_mode, device)
        else:
            regions = [(0.0, len(audio) / SAMPLE_RATE)]
    tasks: List[_ChunkTask] = []
    for a, b in regions:
        span = audio[int(a * SAMPLE_RATE): int(b * SAMPLE_RATE)]
        if len(span) == 0:
            continue
        for chunk, off, sl, sr in chunk_with_stride(span, chunk_s, stride_s, stride_s):
            dur = min(chunk_s, len(span) / SAMPLE_RATE - off)
            tasks.append(_ChunkTask(file_idx, chunk, a, off, sl, sr, dur))
    return tasks


def live_row_steps(lengths: np.ndarray, steps: int) -> int:
    """Decode steps that served a row still decoding, over ``lengths``
    (each row's sampled tokens less eot; its eot step counts too)."""
    return int(np.minimum(np.asarray(lengths, np.int64) + 1, steps).sum())


def decode_batch(params, wire: torch.Tensor, prefix: torch.Tensor, config: WhisperConfig,
                 rules: DecodeRules, policy: DtypePolicy, *, max_len, quantize_kv,
                 num_beams: int = 1, device):
    """One staged batch: int16 (or fp32) wire -> fp32 audio on the device ->
    ``decode_audio``."""
    audio = wire.to(device, non_blocking=True).float()
    if wire.dtype == torch.int16:
        audio = audio / 32768.0
    return decode_audio(params, audio, prefix, config, rules, policy, max_len=max_len,
                        quantize_kv=quantize_kv, num_beams=num_beams, device=device)


def label_files(
    params,
    config: WhisperConfig,
    tok: WhisperTokenizer,
    audio_paths: Sequence[str],
    output_dir: str,
    cfg: LabelConfig = LabelConfig(),
    policy: DtypePolicy = DtypePolicy(),
    *,
    device=None,
    log_every: int = 10,
    assistant=None,
) -> dict:
    """Transcribe each file to <output_dir>/<stem>.csv; returns stats. Runs
    on ``device`` (cuda unless given). The chunked strategy with pooling
    follows ``cfg.wire_mode`` as in the JAX package: resident when asked, or
    under "auto" when the VAD mode allows it; a resident request with
    another VAD mode raises. The sequential strategy, ``pooled=False``, or
    an ``assistant`` ((params, config) of a draft model: speculative
    decoding) labels file by file. The stats' ``spans`` and ``counts`` are
    what this call took of the port's spans and counters."""
    dev = resolve_device(device)
    _check_supported(cfg)
    os.makedirs(output_dir, exist_ok=True)
    snap = profiling.snapshot()
    stats = _label_files_routed(params, config, tok, audio_paths, output_dir, cfg, policy,
                                device=dev, log_every=log_every, assistant=assistant)
    stats.update(profiling.since(snap))
    return stats


def _label_files_routed(params, config, tok, audio_paths, output_dir, cfg, policy, *, device,
                        log_every, assistant) -> dict:
    if cfg.strategy != "chunked" or not cfg.pooled or assistant is not None:
        return _label_files_per_file(params, config, tok, audio_paths, output_dir, cfg, policy,
                                     device=device, log_every=log_every, assistant=assistant)
    resident_ok = (cfg.wire_mode in ("auto", "resident")
                   and (not cfg.vad_regions
                        or cfg.vad_mode in ("spectral", "spectral-device", "off")))
    if cfg.wire_mode == "resident" or (cfg.wire_mode == "auto" and resident_ok):
        if not resident_ok:
            raise ValueError("wire_mode='resident' requires spectral/off VAD")
        from .label_resident import label_files_resident

        return label_files_resident(params, config, tok, audio_paths, output_dir, cfg,
                                    policy, device=device, log_every=log_every)
    return _label_files_pooled(params, config, tok, audio_paths, output_dir, cfg, policy,
                               device=device, log_every=log_every)


def _label_files_pooled(params, config: WhisperConfig, tok: WhisperTokenizer,
                        audio_paths: Sequence[str], output_dir: str, cfg: LabelConfig,
                        policy: DtypePolicy, *, device: torch.device,
                        log_every: int) -> dict:
    """The chunk-queue scheduler: every file's VAD-region chunks feed one
    shared queue; the device sees only full ``batch_size`` batches;
    segments scatter back to per-file CSVs. File loading (and host VAD)
    run ahead on ``io_threads`` threads."""
    dev = device
    params = prepare_params(params, policy, dev)

    special = tok.special
    rules = DecodeRules.from_special(special, timestamps=True)
    sot_seq = tok.sot_sequence(cfg.language, cfg.task, timestamps=True)
    chunk_s = cfg.chunk_s or config.max_source_positions * 2 * 160 / SAMPLE_RATE
    stride_s = cfg.stride_s if cfg.stride_s is not None else chunk_s / 6.0
    bs = cfg.batch_size
    max_len = len(sot_seq) + cfg.max_decode_tokens if cfg.max_decode_tokens else None
    prefix = torch.tensor([sot_seq] * bs, dtype=torch.int32, device=dev)

    states: dict = {}  # file_idx -> {segments, remaining, produced, out_csv}
    buffer: List[_ChunkTask] = []
    stats = dict(files=0, skipped=0, failed=0, audio_seconds=0.0,
                 chunks=0, batches=0, pad_slots=0, vad_s=0.0,
                 decode_s=0.0, stage_wait_s=0.0, load_wait_s=0.0, scatter_s=0.0)
    t0 = time.time()

    def finish_file(idx):
        st = states.pop(idx)
        st["segments"].sort(key=lambda s: s.start)
        write_label_csv(st["out_csv"], LongformResult(st["segments"]), tok)
        stats["files"] += 1
        if log_every and stats["files"] % log_every == 0:
            rate = stats["audio_seconds"] / max(time.time() - t0, 1e-6)
            print(f"[label] {stats['files']} files, {rate:.1f} audio-s/s")

    # staging: a thread stacks each batch on the wire (int16: lossless for
    # PCM16 sources) into pinned memory so the upload of batch N+1 overlaps
    # the decode of batch N
    stage_pool = ThreadPoolExecutor(max_workers=1)
    staged: deque = deque()  # (batch, future of the wire tensor)

    def stack(batch: List[_ChunkTask]) -> torch.Tensor:
        pad_n = bs - len(batch)
        arr = np.stack([t.audio for t in batch] + [batch[-1].audio] * pad_n)
        if cfg.wire_dtype == "int16":
            arr = np.clip(np.round(arr * 32768.0), -32768, 32767).astype(np.int16)
        wire = torch.from_numpy(arr)
        return wire.pin_memory() if dev.type == "cuda" else wire

    def process_oldest():
        batch, fut = staged.popleft()
        with profiling.span("label.stage_wait", stats, "stage_wait_s"):
            wire = fut.result()
        with profiling.span("label.decode", stats, "decode_s"):
            res = decode_batch(params, wire, prefix, config, rules, policy, max_len=max_len,
                               quantize_kv=cfg.quantize_kv, num_beams=cfg.num_beams,
                               device=dev)
        with profiling.span("label.fetch", stats, "decode_s"):
            tokens = res.tokens.cpu().numpy()
            lengths = res.lengths.cpu().numpy()
        stats["batches"] += 1
        stats["pad_slots"] += bs - len(batch)
        profiling.count("label.live_row_steps", live_row_steps(lengths[:len(batch)], res.steps))
        with profiling.span("label.scatter", stats, "scatter_s"):
            for j, t in enumerate(batch):
                sampled = tokens[j][len(sot_seq): len(sot_seq) + int(lengths[j])].tolist()
                segs, _, _ = _tokens_to_segments(sampled, special, t.offset,
                                                 t.window_duration)
                lo = t.offset + t.stride_left
                hi = t.offset + chunk_s - t.stride_right
                st = states[t.file_idx]
                for s in segs:
                    if (s.start >= lo or t.stride_left == 0.0) and (
                        s.start < hi or t.stride_right == 0.0
                    ):
                        s.start += t.region_start  # post-shift: per-file order
                        s.end += t.region_start
                        st["segments"].append(s)
                st["remaining"] -= 1
                if st["remaining"] == 0 and st["produced"]:
                    finish_file(t.file_idx)

    def drain(force=False):
        while len(buffer) >= bs or (force and buffer):
            batch = buffer[:bs]
            del buffer[:bs]
            staged.append((batch, stage_pool.submit(stack, batch)))
            while len(staged) > max(cfg.stage_depth, 1):
                process_oldest()
        while force and staged:
            process_oldest()

    # spectral scores on the device go through one batched scorer call for
    # several files (flush_vad); host scorers run in the loader threads
    batched_vad = (cfg.vad_regions
                   and resolve_vad_mode(cfg.vad_mode, dev) == "spectral-device")

    def load_one(item):
        idx, path = item
        try:
            audio = load_audio_16k(path)
        except READ_ERRORS as e:
            return idx, None, 0.0, f"{e}"  # tolerate unreadable files
        secs = len(audio) / SAMPLE_RATE
        if not energy_vad_is_speech(audio, cfg.energy_vad_threshold):
            return idx, [], secs, None
        if batched_vad:
            return idx, audio, secs, None  # VAD later, batched
        return idx, _file_to_tasks(idx, audio, cfg, chunk_s, stride_s, dev), secs, None

    todo = []
    for idx, path in enumerate(audio_paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_csv = os.path.join(output_dir, f"{stem}.csv")
        if os.path.exists(out_csv):  # resumable
            stats["skipped"] += 1
            continue
        todo.append((idx, path))
        states[idx] = dict(segments=[], remaining=0, produced=False, out_csv=out_csv)

    def ingest_tasks(idx, tasks):
        st = states[idx]
        st["remaining"] = len(tasks)
        st["produced"] = True
        if not tasks:  # no speech anywhere: empty CSV now
            finish_file(idx)
            return
        buffer.extend(tasks)
        stats["chunks"] += len(tasks)
        drain()

    vad_pending: List = []  # (idx, audio) awaiting a batched VAD call
    vad_pending_segs = 0

    def flush_vad(force=False):
        nonlocal vad_pending, vad_pending_segs
        if not vad_pending or (not force and vad_pending_segs < _VAD_CALL_SEGS):
            return
        with profiling.span("label.vad", stats, "vad_s"):
            regions_list = spectral_regions_device_batch([a for _, a in vad_pending], dev)
        for (idx, audio), regions in zip(vad_pending, regions_list):
            ingest_tasks(idx, _file_to_tasks(idx, audio, cfg, chunk_s, stride_s, dev,
                                             regions=regions))
        vad_pending, vad_pending_segs = [], 0

    # bounded look-ahead: io_threads workers load files while the device
    # decodes; files enter the queue in submission order
    with ThreadPoolExecutor(max_workers=max(cfg.io_threads, 1)) as pool, stage_pool:
        inflight = []
        it = iter(todo)

        def top_up():
            while len(inflight) < max(cfg.io_threads, 1) * 2:
                try:
                    item = next(it)
                except StopIteration:
                    return
                inflight.append(pool.submit(load_one, item))

        top_up()
        while inflight:
            with profiling.span("label.load_wait", stats, "load_wait_s"):
                idx, payload, secs, err = inflight.pop(0).result()
            top_up()
            if payload is None:
                print(f"[label] failed to read {audio_paths[idx]}: {err}")
                states.pop(idx)
                stats["failed"] += 1
                continue
            stats["audio_seconds"] += secs
            if batched_vad and isinstance(payload, np.ndarray):
                vad_pending.append((idx, payload))
                vad_pending_segs += max(-(-len(payload) // _VAD_SEG_SAMPLES), 1)
                flush_vad()
            else:
                ingest_tasks(idx, payload)
        flush_vad(force=True)
        drain(force=True)

    if states:
        raise RuntimeError(f"unfinished files: {sorted(states)}")
    stats["wall_seconds"] = time.time() - t0
    stats["device"] = str(dev)
    return stats


def _label_files_per_file(params, config: WhisperConfig, tok: WhisperTokenizer,
                          audio_paths: Sequence[str], output_dir: str, cfg: LabelConfig,
                          policy: DtypePolicy, *, device: torch.device, log_every: int,
                          assistant=None) -> dict:
    """One file at a time: each VAD region (or the whole file) through
    ``chunked_decode`` or ``sequential_decode`` (``_speculative_chunked``
    with an ``assistant``), its segments shifted back by the region's start
    and the file's segments sorted by start. A file below the energy
    threshold gets an empty CSV and is not counted; an unreadable file is
    skipped and counted in ``failed``. Speculative runs add the mean draft
    accept rate over windows (``draft_accept_rate``), the windows and the
    teacher's rounds to the stats."""
    params = prepare_params(params, policy, device)
    stats = dict(files=0, skipped=0, failed=0, audio_seconds=0.0)
    spec_windows: List[tuple] = []  # (accept rate, rounds) of each speculative window
    t0 = time.time()

    def decode_span(span: np.ndarray) -> LongformResult:
        if assistant is not None:
            return _speculative_chunked(params, config, assistant, span, tok, policy, cfg,
                                        device, spec_windows)
        if cfg.strategy == "chunked":
            return chunked_decode(params, span, config, tok, policy, language=cfg.language,
                                  task=cfg.task, batch_size=cfg.batch_size, chunk_s=cfg.chunk_s,
                                  stride_s=cfg.stride_s, quantize_cross_kv=cfg.quantize_kv,
                                  num_beams=cfg.num_beams,
                                  max_decode_tokens=cfg.max_decode_tokens, device=device)
        return sequential_decode(params, span, config, tok, policy, language=cfg.language,
                                 task=cfg.task, quantize_cross_kv=cfg.quantize_kv,
                                 num_beams=cfg.num_beams, device=device)

    for path in audio_paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        out_csv = os.path.join(output_dir, f"{stem}.csv")
        if os.path.exists(out_csv):  # resumable
            stats["skipped"] += 1
            continue
        try:
            audio = load_audio_16k(path)
        except READ_ERRORS as e:
            print(f"[label] failed to read {path}: {e}")
            stats["failed"] += 1
            continue
        if not energy_vad_is_speech(audio, cfg.energy_vad_threshold):
            write_label_csv(out_csv, LongformResult(segments=[]), tok)
            continue
        if cfg.vad_regions and cfg.vad_mode != "off":
            segs = []
            for a, b in detect_speech_regions(audio, cfg.vad_mode, device):
                r = decode_span(audio[int(a * SAMPLE_RATE): int(b * SAMPLE_RATE)])
                for s in r.segments:
                    s.start += a
                    s.end += a
                segs.extend(r.segments)
            segs.sort(key=lambda s: s.start)  # the CSV is in time order
            res = LongformResult(segments=segs)
        else:
            res = decode_span(audio)
        write_label_csv(out_csv, res, tok)
        stats["files"] += 1
        stats["audio_seconds"] += len(audio) / SAMPLE_RATE
        if log_every and stats["files"] % log_every == 0:
            rate = stats["audio_seconds"] / max(time.time() - t0, 1e-6)
            print(f"[label] {stats['files']}/{len(audio_paths)} files, {rate:.1f} audio-s/s")
    stats["wall_seconds"] = time.time() - t0
    stats["device"] = str(device)
    if assistant is not None:
        stats.update(draft_accept_rate=float(np.mean([r for r, _ in spec_windows]))
                     if spec_windows else 0.0, spec_windows=len(spec_windows),
                     spec_rounds=sum(n for _, n in spec_windows))
    return stats


def _speculative_chunked(params, config: WhisperConfig, assistant, audio: np.ndarray,
                         tok: WhisperTokenizer, policy: DtypePolicy, cfg: LabelConfig, device,
                         spec_windows: list) -> LongformResult:
    """Chunked long-form labelling by speculative decoding, one strided
    window at a time: log-mel (kernel) and the teacher's encode, the
    student's own mel and encode unless it shares the teacher's encoder
    (same width and depth), then ``speculative_decode``; each window's
    segments that start inside its core are kept, as in the chunk path.
    Appends (draft accept rate, rounds) of each window to ``spec_windows``."""
    a_params, a_config = assistant
    special = tok.special
    rules = DecodeRules.from_special(special, timestamps=True)
    sot_seq = tok.sot_sequence(cfg.language, cfg.task, timestamps=True)
    chunk_s = cfg.chunk_s or config.max_source_positions * 2 * 160 / SAMPLE_RATE
    stride_s = cfg.stride_s if cfg.stride_s is not None else chunk_s / 6.0
    max_len = len(sot_seq) + cfg.max_decode_tokens if cfg.max_decode_tokens else None
    shared_encoder = (a_config.d_model == config.d_model
                      and a_config.encoder_layers == config.encoder_layers)
    prefix = torch.tensor([sot_seq], dtype=torch.int32, device=device)

    segments = []
    for chunk, offset, sl, sr in chunk_with_stride(audio, chunk_s, stride_s, stride_s):
        wave = torch.from_numpy(chunk[None]).to(device)
        with torch.inference_mode():
            t_enc = M.encode(params, log_mel(wave, config.num_mel_bins), config, policy)
            s_enc = t_enc if shared_encoder else M.encode(
                a_params, log_mel(wave, a_config.num_mel_bins), a_config, policy)
        res = speculative_decode(params, config, a_params, a_config, t_enc, s_enc, prefix,
                                 rules, policy, num_draft_tokens=cfg.num_draft_tokens,
                                 max_len=max_len, device=device)
        spec_windows.append((res.draft_accept_rate, res.rounds))
        sampled = res.tokens[0, len(sot_seq): len(sot_seq) + res.length].tolist()
        window_dur = min(chunk_s, len(audio) / SAMPLE_RATE - offset)
        segs, _, _ = _tokens_to_segments(sampled, special, offset, window_dur)
        lo, hi = offset + sl, offset + chunk_s - sr
        for s in segs:
            if (s.start >= lo or sl == 0.0) and (s.start < hi or sr == 0.0):
                segments.append(s)
    segments.sort(key=lambda s: s.start)
    return LongformResult(segments=segments)


def run_labelling(manifest_path: str, model_dir: str, output_dir: str,
                  cfg: LabelConfig = LabelConfig(), tokenizer_dir: Optional[str] = None,
                  assistant_dir: Optional[str] = None,
                  validation_manifest: Optional[str] = None, *,
                  policy: DtypePolicy = DtypePolicy(), device=None) -> dict:
    """CLI entry: load the model and label this process's shard of the
    manifest's files.
    ``assistant_dir`` loads a draft model on the same device and switches
    on speculative decoding. With
    ``validation_manifest`` (a labelled split: audio with transcript txts
    beside it) the split is labelled too and the pseudo-labels are scored
    against its transcripts (``stats["validation"]``)."""
    from ..models.io import load_model

    _check_supported(cfg)
    dev = resolve_device(device)
    params, config = load_model(model_dir)
    params = prepare_params(params, policy, dev)  # once for both runs
    tok = (WhisperTokenizer.from_pretrained_dir(tokenizer_dir)
           if tokenizer_dir else WhisperTokenizer())
    assistant = None
    if assistant_dir:
        a_params, a_config = load_model(assistant_dir)
        assistant = (prepare_params(a_params, policy, dev), a_config)
    paths = read_manifest(manifest_path).absolute_paths()
    paths = paths[host_local_slice(len(paths))]
    stats = label_files(params, config, tok, paths, output_dir, cfg, policy, device=dev,
                        assistant=assistant)
    if validation_manifest:
        stats["validation"] = validate_labels(params, config, tok, validation_manifest,
                                              output_dir, cfg, policy, device=dev,
                                              assistant=assistant)
    return stats


def validate_labels(params, config: WhisperConfig, tok: WhisperTokenizer,
                    validation_manifest: str, output_dir: str, cfg: LabelConfig,
                    policy: DtypePolicy = DtypePolicy(), *, device=None,
                    assistant=None) -> dict:
    """Label a ground-truth split through the same path as the production
    files, into ``<output_dir>/validation/``, and score each file's CSV text
    (normalized) against the first line of its transcript txt (markers
    stripped, normalized) with MixErrorRate: returns {mer, en_wer, zh_cer,
    n_files}, or {mer: None, n_files: 0} when no pair exists."""
    from ..text.metrics import MixErrorRate
    from ..text.normalizer import BasicTextNormalizer
    from ..text.tokenizer import strip_markers

    vman = read_manifest(validation_manifest)
    v_audio = vman.absolute_paths()
    v_txt = vman.transcript_paths()
    val_dir = os.path.join(output_dir, "validation")
    os.makedirs(val_dir, exist_ok=True)
    label_files(params, config, tok, v_audio, val_dir, cfg, policy, device=device, log_every=0,
                assistant=assistant)
    normalizer = BasicTextNormalizer()
    preds, refs = [], []
    for apath, tpath in zip(v_audio, v_txt):
        stem = os.path.splitext(os.path.basename(apath))[0]
        csv_path = os.path.join(val_dir, f"{stem}.csv")
        if not (os.path.exists(csv_path) and os.path.exists(tpath)):
            continue
        with open(csv_path, encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        preds.append(normalizer("".join(r["text"] for r in rows)))
        with open(tpath, encoding="utf-8") as f:
            refs.append(normalizer(strip_markers(f.readline().strip())))
    if not preds:
        return {"mer": None, "n_files": 0}
    scores = MixErrorRate(separate_language=True).compute(preds, refs)
    return {"mer": scores["MER"], "en_wer": scores["EN WER"], "zh_cer": scores["ZH CER"],
            "n_files": len(preds)}
