"""Device-resident pooled labelling: one upload, VAD and chunks on the device
(port of taiwan_whisper_tpu/pipeline/label_resident.py).

The staged chunk scheduler (label.py) sends every audio byte to the device
twice, once for VAD scoring and once as decode chunks, and stacks chunk
batches on the host. Here the corpus streams through fixed-size group
buffers that stay on the device:

  host                         device
  ----                         ------
  pack files (segment-aligned,
  flat int16) ──upload──────▶  group buffer g          [one upload]
                               VAD scores: static 120 s slices of g
  hysteresis → regions →
  chunk start indices ───────▶ decode_from_bufs(g, g+1): per-row slices
                               of the resident stream → /32768 → mel →
                               encode → greedy decode

Chunks and batches may span two consecutive groups (a file of any length
just occupies several groups); each decode call sees the concatenation of
its group pair. Wire bytes per audio second: 32 KB (int16, plus ~2%
segment padding), with no host chunk stacking.

VAD note: scores come from the same stream layout the per-file scorer
uses, except that a file's final 25 ms window may read the next file's
first samples instead of zero padding (segment-aligned stream); at most
the last score block of a file can differ, and the hysteresis absorbs it.

Uploads: each sealed group is copied from pageable host memory with a
blocking ``.to(device)`` on the default stream, which is also the stream
the VAD scorer and the decode run on, by one upload thread (so host
packing overlaps the copy). Stream order alone then makes every kernel
that reads a group run after its copy, the numpy buffer is never reused
(each seal makes a new one), and a freed group's memory can only be
reused by later work on that same stream: no event or ``record_stream``
is needed. A pinned, non-blocking copy on a side stream would overlap the
copy with decode work; it is not done, because the label path is bound by
the decode loop's host time, not by uploads.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..audio.io import load_audio_16k
from ..decode.longform import LongformResult, _tokens_to_segments
from ..decode.rules import DecodeRules
from ..models.config import DtypePolicy, WhisperConfig
from ..models.params import prepare_params
from ..text.tokenizer import WhisperTokenizer
from ..utils.profiling import count, span
from .vad import (_VAD_CALL_SEGS, _VAD_SEG_SAMPLES, _WIN, SAMPLE_RATE, _scores_dict,
                  _device_scorer, spectral_speech_regions)

SEG = _VAD_SEG_SAMPLES  # 120 s of samples
CAP_SEGS = 16  # segments per group buffer (32 min of stream)


def chunk_spans(span_len: int, chunk_len: int, stride_l: int, stride_r: int):
    """Index-space mirror of decode/longform.py::chunk_with_stride:
    yields (start_sample, offset_s, stride_left_s, stride_right_s,
    valid_samples) over a region of ``span_len`` samples."""
    step = chunk_len - stride_l - stride_r
    assert step > 0
    out = []
    pos = 0
    while True:
        start = max(pos - stride_l, 0) if pos > 0 else 0
        is_first = start == 0
        is_last = start + chunk_len >= span_len
        sl = 0.0 if is_first else stride_l / SAMPLE_RATE
        sr = 0.0 if is_last else stride_r / SAMPLE_RATE
        valid = min(chunk_len, span_len - start)
        out.append((start, start / SAMPLE_RATE, sl, sr, valid))
        if is_last:
            break
        pos = start + chunk_len - stride_r
    return out


@dataclasses.dataclass
class _ResidentTask:
    """One chunk to decode, addressed in stream coordinates."""

    file_idx: int
    group: int  # group index of the chunk's first sample
    start: int  # ABSOLUTE stream sample index
    valid: int  # real samples (rest is zero-masked on device)
    region_start: float
    offset: float  # seconds within the region
    stride_left: float
    stride_right: float
    window_duration: float
    # packed windows: [(dst_start_s, dst_end_s, region_abs_start_s)] —
    # piecewise map from packed-window time back to the file timeline
    pieces: Optional[list] = None


def map_packed_segments(segments, pieces):
    """Map segments decoded in packed-window time back to file time.

    Each piece is (dst_start_s, dst_end_s, src_abs_start_s). A segment is
    attributed to the piece containing its START (segments starting in a
    separator/pad snap to the next piece); start and end shift by that
    piece's offset, the end clamped into the piece (plus separator slack).
    """
    out = []
    for s in segments:
        piece = None
        for p in pieces:
            if s.start < p[1]:
                piece = p
                break
        if piece is None or s.end <= piece[0]:
            continue  # entirely in trailing pad
        d0, d1, src = piece
        delta = src - d0
        s.start = max(s.start, d0) + delta
        s.end = min(max(s.end, s.start - delta), d1 + 0.5) + delta
        out.append(s)
    return out


@dataclasses.dataclass
class _FileState:
    idx: int
    out_csv: str
    n_samples: int
    stream_base: int  # segment-aligned stream position of sample 0
    n_seg: int
    seg_scores: list  # [3, nb] arrays, one per segment, in order
    segments: list = dataclasses.field(default_factory=list)
    remaining: int = -1  # chunks not yet decoded (-1: regions not known yet)
    audio_i16: Optional[np.ndarray] = None  # retained until tasks built
    # (needed by region packing, which re-assembles short regions)

    def touched_groups(self, l_stream: int):
        if self.n_seg == 0:
            return range(0)
        first = self.stream_base // l_stream
        last = (self.stream_base + self.n_seg * SEG - 1) // l_stream
        return range(first, last + 1)


def gather_rows(buf_a: torch.Tensor, buf_b: torch.Tensor, starts: np.ndarray,
                valid: np.ndarray, *, chunk_len: int, l_stream: int) -> torch.Tensor:
    """[len(starts), chunk_len] fp32 audio rows of the virtual stream
    ``buf_a[:l_stream] ‖ buf_b ‖ zeros(chunk_len - WIN)``: row j is the
    chunk_len samples at ``starts[j]``, zero past ``valid[j]``, / 32768.
    The zero tail gives every admissible row start (a rider near the end
    of buf_b) a whole window; a start outside it raises, never clamps."""
    virt = torch.cat([buf_a[:l_stream], buf_b,
                      buf_a.new_zeros(max(chunk_len - _WIN, 0))])
    bad = [int(s) for s in starts if s < 0 or s + chunk_len > virt.numel()]
    if bad:
        raise IndexError(f"chunk starts {bad} leave the {virt.numel()}-sample stream")
    rows = torch.stack([virt[int(s): int(s) + chunk_len] for s in starts])
    keep = (torch.arange(chunk_len, device=rows.device)[None, :]
            < torch.from_numpy(np.asarray(valid, np.int64)).to(rows.device)[:, None])
    return torch.where(keep, rows, 0).float() / 32768.0


def label_files_resident(
    params,
    config: WhisperConfig,
    tok: WhisperTokenizer,
    audio_paths: Sequence[str],
    output_dir: str,
    cfg,  # LabelConfig
    policy: DtypePolicy,
    *,
    device: torch.device,
    log_every: int = 10,
) -> dict:
    from .label import (READ_ERRORS, decode_audio, energy_vad_is_speech, live_row_steps,
                        write_label_csv)

    dev = device
    params = prepare_params(params, policy, dev)
    special = tok.special
    rules = DecodeRules.from_special(special, timestamps=True)
    sot_seq = tok.sot_sequence(cfg.language, cfg.task, timestamps=True)
    chunk_s = cfg.chunk_s or config.max_source_positions * 2 * 160 / SAMPLE_RATE
    stride_s = cfg.stride_s if cfg.stride_s is not None else chunk_s / 6.0
    chunk_len = int(chunk_s * SAMPLE_RATE)
    stride_len = int(stride_s * SAMPLE_RATE)
    # group capacity: smaller groups seal (and upload, VAD-score, decode)
    # earlier, pipelining ingest with decode
    cap_segs = cfg.group_segs or CAP_SEGS
    l_stream = cap_segs * SEG
    l_buf = l_stream + _WIN  # +WIN: VAD slice of the last segment stays in-buf
    bs = cfg.batch_size
    max_len = (len(sot_seq) + cfg.max_decode_tokens
               if cfg.max_decode_tokens else None)
    prefix = torch.tensor([sot_seq] * bs, dtype=torch.int32, device=dev)
    seg_score = _device_scorer(dev)

    def vad_group(buf):  # [l_buf] i16 -> [cap_segs, 3, nb], in scorer calls
        with torch.inference_mode():
            return torch.cat([
                seg_score(torch.stack([buf[s * SEG: s * SEG + SEG + _WIN]
                                       for s in range(c, min(c + _VAD_CALL_SEGS, cap_segs))]))
                for c in range(0, cap_segs, _VAD_CALL_SEGS)])

    def decode_from_bufs(buf_a, buf_b, starts, valid):
        audio = gather_rows(buf_a, buf_b, starts, valid, chunk_len=chunk_len,
                            l_stream=l_stream)
        return decode_audio(params, audio, prefix, config, rules, policy, max_len=max_len,
                            quantize_kv=cfg.quantize_kv, num_beams=cfg.num_beams, device=dev)

    os.makedirs(output_dir, exist_ok=True)
    stats = dict(files=0, skipped=0, failed=0, audio_seconds=0.0,
                 chunks=0, batches=0, pad_slots=0, groups=0,
                 vad_s=0.0, decode_s=0.0, upload_wait_s=0.0, load_wait_s=0.0, scatter_s=0.0)
    t0 = time.time()

    files: Dict[int, _FileState] = {}
    group_open_files: Dict[int, int] = {}  # unfinished files touching group

    def finish_file(fs: _FileState):
        fs.segments.sort(key=lambda s: s.start)
        write_label_csv(fs.out_csv, LongformResult(fs.segments), tok)
        files.pop(fs.idx)
        for g in fs.touched_groups(l_stream):
            group_open_files[g] -= 1
        free_groups()
        stats["files"] += 1
        if log_every and stats["files"] % log_every == 0:
            rate = stats["audio_seconds"] / max(time.time() - t0, 1e-6)
            print(f"[label] {stats['files']} files, {rate:.1f} audio-s/s")

    # ---- group packing (host) --------------------------------------------
    group_parts: List[np.ndarray] = []  # filled np arrays for current group
    group_fill = 0  # samples filled in current group stream
    group_no = 0
    dev_groups: Dict[int, torch.Tensor] = {}  # group -> device buffer
    group_pending_chunks: Dict[int, int] = {}  # refcount for freeing
    zeros_buf = None  # lazy [l_buf] device zeros for the last-pair call

    upload_pool = ThreadPoolExecutor(max_workers=1)
    upload_futs: deque = deque()  # (group_no, future)

    task_q: deque = deque()  # _ResidentTask in stream order
    vad_waiting: List[_FileState] = []  # files with segments not all scored

    def seal_group(next_head: Optional[np.ndarray] = None):
        """Close the current group and upload it. ``next_head`` carries the
        first WIN samples of the stream continuation (a file spanning into
        the next group), so the group-tail VAD slice sees the same samples
        the per-file scorer would."""
        nonlocal group_parts, group_fill, group_no
        if group_fill == 0:
            return
        buf = np.zeros(l_buf, np.int16)
        pos = 0
        for part in group_parts:
            buf[pos: pos + len(part)] = part
            pos += len(part)
        if next_head is not None and pos >= l_stream:
            buf[l_stream: l_stream + len(next_head)] = next_head[:_WIN]
        upload_futs.append((group_no, upload_pool.submit(_put, buf)))
        group_parts, group_fill = [], 0
        group_no += 1
        stats["groups"] += 1

    def _put(buf: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(buf).to(dev)

    def stream_write(arr: np.ndarray):
        """Append int16 samples at the current stream position, splitting
        across group boundaries; returns absolute stream start."""
        nonlocal group_fill
        start_abs = group_no * l_stream + group_fill
        off = 0
        while off < len(arr):
            room = l_stream - group_fill
            take = min(room, len(arr) - off)
            group_parts.append(arr[off: off + take])
            group_fill += take
            off += take
            if group_fill == l_stream:
                seal_group(next_head=arr[off: off + _WIN]
                           if off < len(arr) else None)
        return start_abs

    # ---- VAD + region -> tasks ------------------------------------------
    vad_enabled = cfg.vad_regions and cfg.vad_mode != "off"

    # VAD scores are copied to the host on a side thread so the main loop
    # does not wait on them behind queued device work
    pull_pool = ThreadPoolExecutor(max_workers=1)
    score_futs: deque = deque()  # (group, future of [CAP,3,nb] numpy)
    vad_score_groups: set = set()  # groups containing real-file segments

    def pump_uploads():
        """Receive the next uploaded group; dispatch its VAD scoring with a
        copy of the result on the pull thread. Groups holding only packed
        pseudo-file data (regions already known) are never scored."""
        tg, fut = upload_futs.popleft()
        with span("label.upload_wait", stats, "upload_wait_s"):
            dev_groups[tg] = fut.result()
        if vad_enabled and tg in vad_score_groups:
            with span("label.vad", stats, "vad_s"):
                res = vad_group(dev_groups[tg])
            score_futs.append((tg, pull_pool.submit(lambda r=res: r.cpu().numpy())))

    def pump_scores(force=False):
        """Deliver completed VAD scores (main thread — deliver_scores may
        recurse into drain/run_batch)."""
        while score_futs and (force or score_futs[0][1].done()):
            tg, fut = score_futs.popleft()
            with span("label.vad", stats, "vad_s"):
                scores = fut.result()
            deliver_scores(tg, scores)

    def ensure_group(g) -> torch.Tensor:
        # callers hold a live task for g (refcounted), so g cannot be freed
        # by the pump recursion; if g is absent its upload must be pending
        while g not in dev_groups:
            if not upload_futs:
                raise RuntimeError(f"group {g} unavailable (freed or unsealed)")
            pump_uploads()
        return dev_groups[g]

    def deliver_scores(g, scores):
        done = []
        for fs in vad_waiting:
            # which of this file's segments live in group g?
            for s in range(fs.n_seg):
                seg_abs = fs.stream_base + s * SEG
                if seg_abs // l_stream == g and fs.seg_scores[s] is None:
                    fs.seg_scores[s] = scores[(seg_abs % l_stream) // SEG]
            if all(x is not None for x in fs.seg_scores):
                done.append(fs)
        for fs in done:
            vad_waiting.remove(fs)
            file_regions_to_tasks(fs)

    # ---- region packing (opt-in): short regions share decode windows ----
    windows_per_seg = max(SEG // chunk_len, 1)
    packed_buffer: List = []  # (file_idx, window int16[chunk_len], valid,
    # pieces) awaiting a full segment's worth of windows
    sep_len = int(cfg.pack_separator_s * SAMPLE_RATE)

    def flush_packed(force=False):
        """Write accumulated packed windows into the stream as one
        segment-aligned pseudo-file (alignment keeps file VAD bookkeeping
        intact) and enqueue their decode tasks."""
        while packed_buffer and (
            len(packed_buffer) >= windows_per_seg or force
        ):
            batch_w = packed_buffer[:windows_per_seg]
            del packed_buffer[:windows_per_seg]
            seg_arr = np.zeros(windows_per_seg * chunk_len, np.int16)
            for i, (_, win, _, _) in enumerate(batch_w):
                seg_arr[i * chunk_len: (i + 1) * chunk_len] = win
            # pad the pseudo-file to whole segments (zero windows get no
            # tasks and are never decoded)
            pad = (-len(seg_arr)) % SEG
            if pad:
                seg_arr = np.concatenate(
                    [seg_arr, np.zeros(pad, np.int16)])
            base = stream_write(seg_arr)
            tasks = []
            for i, (fidx, _, valid, pieces) in enumerate(batch_w):
                abs_start = base + i * chunk_len
                tasks.append(_ResidentTask(
                    file_idx=fidx,
                    group=abs_start // l_stream,
                    start=abs_start,
                    valid=valid,
                    region_start=0.0,
                    offset=0.0,
                    stride_left=0.0,
                    stride_right=0.0,
                    window_duration=valid / SAMPLE_RATE,
                    pieces=pieces,
                ))
            for t in tasks:
                group_pending_chunks[t.group] = (
                    group_pending_chunks.get(t.group, 0) + 1)
            task_q.extend(tasks)
            stats["chunks"] += len(tasks)

    def file_regions_to_tasks(fs: _FileState, regions=None):
        total_s = fs.n_samples / SAMPLE_RATE
        if regions is None:
            sc = _scores_dict(np.stack(fs.seg_scores), total_s)
            audio_dummy = np.empty(fs.n_samples, np.float32)  # length only
            regions = spectral_speech_regions(audio_dummy, scores=sc)
        tasks = []
        pack_bins: List[list] = []
        cur_bin: list = []
        cur_len = 0
        for a, b in regions:
            span_start = int(a * SAMPLE_RATE)
            span_len = int(b * SAMPLE_RATE) - span_start
            if span_len <= 0:
                continue
            if (cfg.pack_regions and span_len < chunk_len
                    and fs.audio_i16 is not None):
                add = span_len + (sep_len if cur_bin else 0)
                if cur_bin and cur_len + add > chunk_len:
                    pack_bins.append(cur_bin)
                    cur_bin, cur_len = [], 0
                    add = span_len
                cur_bin.append((a, span_start, span_len))
                cur_len += add
                continue
            for start, off_s, sl, sr, valid in chunk_spans(
                span_len, chunk_len, stride_len, stride_len
            ):
                abs_start = fs.stream_base + span_start + start
                tasks.append(_ResidentTask(
                    file_idx=fs.idx,
                    group=abs_start // l_stream,
                    start=abs_start,
                    valid=valid,
                    region_start=a,
                    offset=off_s,
                    stride_left=sl,
                    stride_right=sr,
                    window_duration=min(chunk_s,
                                        span_len / SAMPLE_RATE - off_s),
                ))
        if cur_bin:
            pack_bins.append(cur_bin)
        for bin_ in pack_bins:  # assemble packed windows (host copy)
            win = np.zeros(chunk_len, np.int16)
            pieces = []
            pos = 0
            for (a, ss, sl) in bin_:
                win[pos: pos + sl] = fs.audio_i16[ss: ss + sl]
                pieces.append((pos / SAMPLE_RATE, (pos + sl) / SAMPLE_RATE,
                               a))
                pos += sl + sep_len
            valid = min(pos - sep_len, chunk_len)
            packed_buffer.append((fs.idx, win, valid, pieces))
        fs.audio_i16 = None
        fs.remaining = len(tasks) + len(pack_bins)
        if fs.remaining == 0:
            finish_file(fs)
            return
        for t in tasks:  # group refcount: keeps buffers resident until
            group_pending_chunks[t.group] = (  # every chunk decoded
                group_pending_chunks.get(t.group, 0) + 1)
        task_q.extend(tasks)
        stats["chunks"] += len(tasks)
        flush_packed()
        drain()

    # ---- decode ----------------------------------------------------------
    def run_batch(batch: List[_ResidentTask]):
        nonlocal zeros_buf
        g = batch[0].group
        buf_a = ensure_group(g)
        # the neighbour buffer is needed only when a row's REAL samples
        # reach into group g+1 (padded tails are zero-masked by `valid`)
        needs_b = any(
            t.group == g + 1 or t.start + t.valid > (g + 1) * l_stream
            for t in batch
        )
        if needs_b:
            buf_b = ensure_group(g + 1)
        else:
            if zeros_buf is None:
                zeros_buf = torch.zeros(l_buf, dtype=torch.int16, device=dev)
            buf_b = zeros_buf
        starts = np.full(bs, 0, np.int64)
        valid = np.zeros(bs, np.int64)
        for j, t in enumerate(batch):
            starts[j] = t.start - g * l_stream
            valid[j] = t.valid
        with span("label.decode", stats, "decode_s"):
            res = decode_from_bufs(buf_a, buf_b, starts, valid)
        decode_inflight.append((batch, res))
        while len(decode_inflight) > 1:
            scatter_oldest()

    def scatter_oldest():
        batch, res = decode_inflight.popleft()
        with span("label.fetch", stats, "decode_s"):
            tokens = res.tokens.cpu().numpy()
            lengths = res.lengths.cpu().numpy()
        stats["batches"] += 1
        stats["pad_slots"] += bs - len(batch)
        count("label.live_row_steps", live_row_steps(lengths[:len(batch)], res.steps))
        with span("label.scatter", stats, "scatter_s"):
            for j, t in enumerate(batch):
                sampled = tokens[j][
                    len(sot_seq): len(sot_seq) + int(lengths[j])
                ].tolist()
                segs, _, _ = _tokens_to_segments(
                    sampled, special, t.offset, t.window_duration
                )
                fs = files[t.file_idx]
                if t.pieces is not None:  # packed window: piecewise re-map
                    fs.segments.extend(map_packed_segments(segs, t.pieces))
                else:
                    lo = t.offset + t.stride_left
                    hi = t.offset + chunk_s - t.stride_right
                    for s in segs:
                        if (s.start >= lo or t.stride_left == 0.0) and (
                            s.start < hi or t.stride_right == 0.0
                        ):
                            s.start += t.region_start
                            s.end += t.region_start
                            fs.segments.append(s)
                fs.remaining -= 1
                group_pending_chunks[t.group] -= 1
                if fs.remaining == 0:
                    finish_file(fs)
            free_groups()

    def free_groups():
        # a group stays resident while (a) any unfinished file's content
        # touches it (its tasks may not even exist yet), (b) any created
        # task still references it, or (c) it may serve as a batch's
        # neighbour buffer (predecessor of an active group)
        min_active = min((t.group for t in task_q), default=group_no)
        for g in list(dev_groups):
            if (group_open_files.get(g, 0) <= 0
                    and group_pending_chunks.get(g, 0) <= 0
                    and g < min_active - 1):
                dev_groups.pop(g, None)

    decode_inflight: deque = deque()  # (batch, DecodeResult not yet read)

    draining = [False]  # reentrancy guard: ensure_group -> deliver_scores
    # -> file_regions_to_tasks -> drain can recurse into a running drain

    def drain(force=False):
        if draining[0]:
            return
        draining[0] = True
        try:
            while task_q and (len(task_q) >= bs or force):
                # only decode chunks whose REAL samples are fully inside
                # sealed (uploaded or upload-queued) groups — with VAD off,
                # tasks can be created while their group still accumulates
                sealed = group_no * l_stream
                if task_q[0].start + task_q[0].valid > sealed:
                    break
                batch = [task_q.popleft()]
                g = batch[0].group
                limit = (g + 2) * l_stream
                while (task_q and len(batch) < bs
                       and task_q[0].group <= g + 1
                       and task_q[0].start + task_q[0].valid
                       <= min(limit, sealed)):
                    batch.append(task_q.popleft())
                run_batch(batch)
            if force:
                while decode_inflight:
                    scatter_oldest()
        finally:
            draining[0] = False

    # ---- main loop -------------------------------------------------------
    def load_one(item):
        idx, path = item
        try:
            audio = load_audio_16k(path)
        except READ_ERRORS as e:
            return idx, None, 0.0, f"{e}"
        if not energy_vad_is_speech(audio, cfg.energy_vad_threshold):
            return idx, False, len(audio) / SAMPLE_RATE, None
        i16 = np.clip(np.round(audio.astype(np.float32) * 32768.0),
                      -32768, 32767).astype(np.int16)
        return idx, i16, len(audio) / SAMPLE_RATE, None

    todo = []
    for idx, path in enumerate(audio_paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_csv = os.path.join(output_dir, f"{stem}.csv")
        if os.path.exists(out_csv):
            stats["skipped"] += 1
            continue
        todo.append((idx, path, out_csv))

    with ThreadPoolExecutor(max_workers=max(cfg.io_threads, 1)) as pool:
        inflight: deque = deque()
        it = iter(todo)

        def top_up():
            while len(inflight) < max(cfg.io_threads, 1) * 2:
                try:
                    idx, path, out_csv = next(it)
                except StopIteration:
                    return
                inflight.append(
                    (out_csv, pool.submit(load_one, (idx, path))))

        try:
            top_up()
            while inflight:
                out_csv, fut = inflight.popleft()
                with span("label.load_wait", stats, "load_wait_s"):
                    idx, payload, secs, err = fut.result()
                top_up()
                if payload is None:
                    print(f"[label] failed to read {audio_paths[idx]}: "
                          f"{err}")
                    stats["failed"] += 1
                    continue
                stats["audio_seconds"] += secs
                if payload is False:  # energy-gated silent file
                    fs = _FileState(idx, out_csv, 0, 0, 0, [])
                    files[idx] = fs
                    finish_file(fs)
                    continue
                n_seg = max(-(-len(payload) // SEG), 1)
                padded = np.zeros(n_seg * SEG, np.int16)
                padded[: len(payload)] = payload
                fs = _FileState(
                    idx=idx, out_csv=out_csv, n_samples=len(payload),
                    stream_base=0, n_seg=n_seg, seg_scores=[None] * n_seg,
                    audio_i16=payload if cfg.pack_regions else None,
                )
                fs.stream_base = stream_write(padded)
                files[idx] = fs
                for g in fs.touched_groups(l_stream):
                    group_open_files[g] = group_open_files.get(g, 0) + 1
                if vad_enabled:
                    vad_waiting.append(fs)
                    vad_score_groups.update(fs.touched_groups(l_stream))
                else:
                    file_regions_to_tasks(
                        fs, regions=[(0.0, fs.n_samples / SAMPLE_RATE)])
                # score any groups already sealed + uploaded
                while upload_futs and upload_futs[0][1].done():
                    pump_uploads()
                pump_scores()
                drain()
            # fixpoint: sealing the tail group delivers the last files'
            # scores, whose regions may append packed windows, whose flush
            # writes new stream data that needs sealing again. The break
            # condition must ALSO require group_fill == 0: when the last
            # flush happens inside pump_scores (a full windows_per_seg set,
            # leaving packed_buffer empty), the packed pseudo-file sits in
            # the still-open group and its tasks could never be decoded.
            while True:
                seal_group()
                while upload_futs:
                    pump_uploads()
                pump_scores(force=True)
                flush_packed(force=True)
                if not packed_buffer and group_fill == 0:
                    break
            drain(force=True)
        finally:
            upload_pool.shutdown(wait=True)
            pull_pool.shutdown(wait=True)

    if files or vad_waiting:
        raise RuntimeError(f"unfinished files: {sorted(files)}")
    stats["wall_seconds"] = time.time() - t0
    stats["device"] = str(dev)
    return stats
