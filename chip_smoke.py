"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py kernels    # only the named phases
                                     # (kernels, label, label_vad, label_beam, longform,
                                     # speculative, prefilter, train, distributed,
                                     # tensor_parallel, packed, sweep, train_agree,
                                     # agree; mel, layer_norm: those kernels' main
                                     # cases)

(``chip_smoke.py _rank <cli args>`` is one rank of the distributed phase's
multi-process runs, and ``chip_smoke.py _tp_rank <spec>`` one of the
tensor_parallel phase's; each phase starts its ranks itself.)

Phases, each raising on failure:

1. build   — compiles every CUDA kernel of taiwan_whisper_tpu_torch from
   the checkout's csrc/ (one nvcc per source, all started together);
   prints ptxas's register and spill lines, each library's spilled bytes
   and, from ``cuobjdump -sass``, the count of wgmma (HGMMA) and TMA-load
   (UTMALDG) instructions in the two attention libraries (fails if either
   is 0), and in each bf16 instantiation of the forward (the non-causal
   and the causal one).
2. kernels — calls each kernel's wrapper, in every variant a driven path
   launches, and holds it against its plain PyTorch version on the same
   inputs, with the tolerance stated beside it: bf16 at the labelling
   path's shapes (large-v2, batch 32), the prefilter's (whisper-base,
   batch 64: encoder attention at 8 heads, cross on bf16 storage, self
   over a 448-position cache at index 447, 200 and 3) and the finetune
   path's (the encoder attention's LSE and backward at batch 8), fp32 at
   the agree phases' (base, batch 4), label_packed's (large-v2, batch 16:
   encoder attention at 20 heads, cross on bf16 storage, self over a
   448-position cache at index 447, 200 and 3), the log-mel kernel at 32,
   64 and 16 x 30 s and with 128 mels, and the LayerNorm kernel (on no path, as in the JAX package) at
   the encoder's LN shape and at d = 384 and 4096; fails if ptxas spilled
   in the mel or LayerNorm kernels. The decoder attention (distillation's
   teacher) at batch 32 x 20 heads over 448 tokens: causal self-attention
   and cross-attention over 1500 encoder positions, each also peaked; and
   away from those shapes (ragged, one row, Sq > Sk, strided views),
   counters checked. The attention kernels are
   also held, both directions, at S = 300, at B = 1 and on q/k/v that are
   strided views of one [B, S, 3, H, 64] buffer, with their launch
   counters checked; the decode kernels on a contiguous (not row-padded)
   cross K/V, which the wrapper must refuse for fp8 and take for fp32,
   and at B = 1, counters checked too. Times kernel, plain version
   and, where one exists, the one PyTorch call that computes the same
   function (CUDA events, median, L2 flushed before every launch; for the
   cross kernel on quantized storage SDPA over the dequantized K/V); for
   the bf16 attention forward, forward with LSE and backward, for the
   decode kernels at the label path's shapes (cross fp8 with 1 and 3
   rows, self bf16 at index 3, 97 and 194), for the log-mel kernel at
   32 x 30 s and for LayerNorm at the encoder's shape, also the mean of
   back-to-back calls and each kernel's device time (torch.profiler), for
   SDPA (the cross kernel's: on the dequantized K/V) and F.layer_norm
   too; for the decode, log-mel and LayerNorm
   kernels the host microseconds per wrapper call and a rerun that must
   be bitwise equal, and for log-mel and LayerNorm that the wrapper's call
   launches one kernel. The cross kernel past one tile of 8 query rows
   (``cross_tile_cases``): 5, 15, 227 and 1135 rows (a beam-5 step, the
   beam-5 prefill, a conditioned prefill with a 223-token prompt, that
   prefill under 5 beams) on int8 and bf16 storage at large-v2 heads and
   batch 8, timed as above beside SDPA over the dequantized K/V and an
   einsum, and the label path's 1- and 3-row calls bitwise equal to the
   same rows of a 15-row call; the self kernel at the beam path's 40 rows
   (batch 8 x 5 beams). Packed int4 storage (two positions a byte) at the
   label path's 1 and 3 rows (b32, bf16 q; timed with a bitwise rerun),
   the agree phase's (fp32 q), the tile cases' 5-1135 rows at b8, and its
   1- and 3-row calls bitwise against a 15-row call at b32; the "8x8"
   variant (int8 x int8 dots) at b32 x 1 row and b8 x 5 rows, each output
   held to 4 steps of p8 of its row (max|V x scale| x pmax / 127, pmax
   the row's largest probability) and at most 1% of the rows off by more
   than 1e-6; and the 6-row,
   batch-1 bf16 call ``extend`` makes at large-v2; and the shapes of
   tensor parallel, a model rank's local heads: encoder attention forward
   and backward at batch 8 with 10 and 5 heads (bf16; SDPA beside) and 10
   (fp32, the tensor_parallel phase's), cross at 10 heads, batch 8, 1 and
   5 rows (bf16 q on bf16 and fp8 storage, fp32 q on fp32 and fp8), self
   at 10 heads over 131 positions (bf16, fp32). The smoke holds no
   older kernel, so it cannot compare with one:
   ``tools/ab_cross_kernel.py --parent DIR`` builds the cross kernel of
   another checkout and checks those calls bitwise against it.
3. label   — the port's ``cli label`` at full large-v2 width with random
   bf16 weights from a seed: 8 synthetic WAVs of 170 s (64 chunks, two
   batches of 32), fp8 cross-KV, VAD off, the staged chunk route, 192-token
   budget; then the same run with ``--quantize_kv 4`` (packed int4), the
   two runs' audio-s/s side by side. Every launch counter is zeroed just
   before each run and read just after, and must equal the count the run
   implies.
4. label_vad — on 2 FLAC files of 170 s of speech-like lecture audio
   (bursts between silent gaps), first the device VAD scorer on the card
   against the same scorer on the CPU, on the corpus's int16 segments:
   scores within ``VAD_TOL`` and equal regions; the VAD must keep more
   than none and less than all of the audio. Then ``cli label
   @configs/label_large_v2.args`` as shipped (no --vad_mode, no
   --wire_mode: spectral VAD scored on the card, and the auto wire mode
   takes the device-resident driver), same checkpoint and budget; then
   the staged chunk route, then the resident route with ``--group_segs
   3`` (groups sealing mid-file, batches spanning two buffers), on the
   same corpus. Each run's launch counters are checked as in label, the
   shipped run must report at least one group and the group_segs run
   more, all three must cut the same chunks and write byte-equal CSVs.
4b. label_beam — ``cli label @configs/label_large_v2_beam.args`` as
   shipped (large-v2, batch 8, 5 beams, int8 cross-KV; spectral VAD and
   the resident route) on 4 FLAC lectures of 60 s with a 64-token budget,
   counters exact as in label; then the beam step of one batch (ms a step
   from two budgets, a traced window: device work by kernel, the cache
   reorder's and the top-k's ms).
4c. longform — on the 32-2 student ``cli init-student`` cuts from the same
   checkpoint: ``cli evaluate`` with ``configs/eval_short.args`` (greedy
   and ``--num_beams 5``), ``eval_longform_sequential.args`` and
   ``eval_longform_chunked.args`` on 1 utterance with a reference, ``cli
   transcribe`` of a 50 s lecture (sequential: more than one window,
   chunked: 2 chunks and the stride merge), and
   ``sequential_decode(temperatures=(0.0,))`` greedy and beam 5 of a 90 s
   lecture, which must
   run a conditioned prefill of more than 8 rows; every run's counters
   must show mel, encoder attention, cross and self launches.
4d. speculative — the 32-2 student drafts, the random large-v2 verifies:
   ``cli evaluate @configs/eval_speculative.args`` on 1 utterance (448
   positions; a second took the phase past its 90 s) and ``cli label @configs/label_large_v2.args
   --assistant`` on 1 FLAC lecture of 30 s with a 64-token budget; rounds,
   draft accept rate, RTF and audio-s/s of each; the counters must show
   mel, encoder attention, self attention and the cross kernel at 1 row
   (the student's steps) and 6 rows (``extend``).
5. prefilter — stage 2 on the port's CLI: ``cli segment`` of 8 FLAC
   lectures of 260 s with seeded pseudo-label CSVs (72 segments), ``cli
   make-manifest --valid_percent 0.1``, then ``cli prefilter
   @configs/prefilter_base_0.4.args`` (batch 64, threshold 0.4, zh) with a
   random full-width whisper-base validator: 2 batches of the 448-token
   budget, launch counters checked as in label. The filter run again on
   the CPU from the card's hyps must write byte-equal files and keep
   everything above every MER. The validator then decodes the first 64
   segments again with torch.profiler on over two windows of 8 greedy
   steps (positions 5-12, as ``tools/profile_label`` traces them, and
   420-427, where the self kernel runs 4-block clusters): device time per
   step by kernel, the device's busy share and the host's launch calls
   per step. Last, the validator at fp32 on 2 segments over the whole
   448-token budget (the self kernel's fp32 cache runs clusters of 2
   blocks from position 97, 4 from 193 and 8 from 385), card vs CPU:
   token agreement at least 0.98.
6. train   — stage 3 at full large-v2 width from the same checkpoint:
   ``cli init-student`` (32-2), ``cli distill`` (ce 0.8, kl 1.0, T 2,
   fp32 masters, bf16 compute, frozen encoder) at batch 32, and at the
   shipped 64 when twice the batch-32 peak memory fits the card, then
   ``cli finetune`` of the student with the encoder trainable at batch 8.
   A few steps each on one synthetic 30 s WAV segment listed many times
   with a byte-level vocab, so every step sees the same batch and the
   loss must fall; launch counters are checked per run (distill: mel 1,
   encoder forward 32 and the teacher's decoder attention 64 per step;
   finetune: mel 1, encoder forward 64, as each checkpointed layer runs
   twice, and backward 32 per step).
6b. distributed — multi-process runs of the port's CLI, every rank a
   process of its own with the launcher's environment (RANK, WORLD_SIZE,
   LOCAL_RANK 0, MASTER_ADDR, MASTER_PORT) and a timeout, its launch
   counters read in the rank: ``cli label @configs/label_large_v2.args
   --distributed`` as 2 ranks sharing the card (no device collective, so
   no NCCL communicator) on 2 FLAC lectures of 60 s with a 64-token
   budget, each rank labelling 1 file, the CSVs byte-equal to a
   one-process run; ``cli prefilter @configs/prefilter_base_0.4.args
   --distributed`` as 2 ranks on the segments of 1 lecture of 260 s,
   disjoint non-empty hyp shards and rank 0's merged files byte-equal to a
   one-process run; ``cli distill --distributed`` at world size 1 (the
   data-parallel step's NCCL all-reduces) from a 32-2 student, 3 steps at
   batch 8 with an eval batch and ``--gen_eval_batches 1``, whose losses
   and ``hf_export`` tensors must equal the plain run's bitwise and whose
   ``metrics.jsonl`` must hold ``eval/gen_mer`` and both prediction
   tables; both step rates logged.
6c. tensor_parallel — tensor parallel at full large-v2 width, 2 ranks
   sharing the card at ``--model_parallel 2``, each joining over gloo
   itself (NCCL refuses two ranks on one card; gloo stages the card's
   tensors through the host, so nothing here is a speed), beside the same
   jobs in this process, all at the fp32 policy through the port's API:
   ``run_distillation`` of the 32-2 student (3 steps at batch 8, an eval
   batch, ``gen_eval_batches`` 1: model group 0 decodes), ``run_finetuning``
   with the encoder trainable (2 steps: the attention backward at 10
   heads), greedy (fp8 cross K/V) and beam-5 decoding of 2 utterances
   with large-v2, 32 tokens. Losses within 1e-4 relative and the
   ``hf_export`` tensors (gathered over the model group) within 1e-4 of
   one process; each rank's greedy and beam tokens agree on at least 0.98
   of positions with one process; each rank's counters show every kernel
   of each job.
6d. packed — the speaker-packing labeller (``pipeline/packing.py``) and
   the corpus utilities on the card: 4 synthetic lectures of 120 s named
   as video IDs, written as WAV, converted to FLAC by ``audio/ingest.py::
   batch_convert``, measured by ``duration_stats`` and laid out by
   ``audio/corpus.py::categorize_corpus`` (move=False; two EECS courses,
   one Law course, one unknown video); each FLAC cut into utterances of
   4-12 s under 2-3 speakers and packed by ``pack_utterances``; then
   ``label_packed`` with the random large-v2 at batch 16 over 24 packs (2
   batches, the second with 8 zero-audio pad rows), the default bf16
   policy (bf16 cross K/V) and timestamps over the whole 448-position
   budget: launch counters exact, the CSV's rows and columns checked,
   packs/s, audio-s/s and ms per batch logged. Then the base preset at the
   fp32 policy (TF32 off) on 2 packs, card vs CPU: ``id``,
   ``condition_on_prev`` and ``text`` equal, transcripts agreeing on at
   least 0.98 of characters (1 - CER); last ``utils/profiling.py``:
   ``device_time`` of ``encode`` at batch 16 inside ``trace(dir)``, the
   trace file parsed (its kernel events logged, not held).
6e. sweep — ``cli sweep --target distill`` through the port's ``cli.main``
   in this process: a grid of 2 learning rates, 2 steps at batch 8 a run,
   on the large-v2 teacher, a 32-2 student and the train phase's repeated
   segment: 2 records, 2 run directories with their ``hf_export``,
   ``best.json`` naming a finite metric, each run's wall and peak device
   memory logged and the second peak within 10% of the first, launch
   counters exact over the sweep.
7. train_agree — a small config (d 256, S 300: a ragged key tile) at the
   fp32 policy with TF32 off, trainable encoder: three train steps on the
   card and on the CPU plain path; losses agree to 1e-4 relative and the
   updated params to 1e-5, launch counters checked.
8. agree   — the base preset at batch 4, fp32 policy with TF32 off, greedy
   for 32 tokens on the card and on the CPU plain path; token agreement
   must be at least 0.98 of positions, and the launch counters, zeroed
   just before the card's run, must equal the count that run implies.
   Then beam search with 5 beams on the same inputs: all hypotheses'
   tokens agree on at least 0.98 of positions, and the counters fit the
   steps run. Then greedy with int4 and with "8x8" cross K/V, card vs CPU
   (0.98 each), and ``speculative_decode`` (first utterance, 64 tokens)
   against the card's teacher greedy: with a 2-layer distilled student and
   with the teacher drafting for itself (accept rate above 0.9), at fp32
   (0.98) and, logged only, at bf16.

Prints the card's name and power limit, a ``kernels`` JSON line (one entry
per kernel case; ``launches`` is its kernel's count over all the driven
paths and all shapes, not the case's, and ``launches_by_path`` splits it by
path), and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, flop/s by operand type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}

LARGE_V2_BATCH = 32
DISTILL_TOKENS = 448  # distillation's label length: decode_train's queries
# the prefilter phase: configs/prefilter_base_0.4.args validates at batch 64
# with a 448-token budget; 8 lectures of 260 s cut into 72 segments (one
# full batch and one of 8 with 56 zero-audio pad rows)
PREFILTER_BATCH, PREFILTER_BUDGET = 64, 448
PREFILTER_LECTURES, PREFILTER_SECONDS, PREFILTER_MIN_SEGMENTS = 8, 260.0, 65
# (first position, steps) of each traced window of the validator's loop
PREFILTER_TRACE_WINDOWS = ((5, 8), (420, 8))
PREFILTER_AGREE = 2  # segments of the validator's fp32 card-vs-CPU check
LABEL_FILES, LABEL_SECONDS, MAX_DECODE_TOKENS = 8, 170.0, 192
AGREE_BATCH, AGREE_TOKENS = 4, 32
# configs/label_large_v2_beam.args: batch 8, 5 beams; the beam label phase
# bounds the budget and labels 4 FLAC lectures of 60 s
BEAM_BATCH, BEAMS, BEAM_TOKENS = 8, 5, 64
BEAM_FILES, BEAM_SECONDS = 4, 60.0
# (first position, steps) of the traced window of the beam loop
BEAM_TRACE_WINDOW = (3 + 24, 8)
# query rows of the cross kernel's multi-tile cases: a beam-5 step, the
# beam-5 prefill of the sot sequence, a conditioned prefill (<|startofprev|>
# + 223 prompt tokens + the sot sequence), and that prefill under 5 beams
TILE_ROWS = (5, 15, 227, 1135)
# the long-form phase: 1 test utterance (evaluate), one lecture of two 30 s
# windows and two strided chunks (transcribe) and a longer one for
# sequential_decode's prompts, which grow window by window to the 223-token
# cap (a 227-row conditioned prefill)
LONGFORM_UTTS, LONGFORM_LECTURE_S, LONGFORM_PROMPT_S = 1, 50.0, 90.0
# the speculative phase (within 90 s): cli evaluate
# @configs/eval_speculative.args on 1 utterance (445 tokens with random
# weights, ~23 s), cli label --assistant on 1 FLAC lecture of 30 s with a
# 64-token budget; speculative_decode takes k = 5 drafts by default
SPEC_UTTS, SPEC_FILES, SPEC_SECONDS, SPEC_TOKENS, DRAFTS = 1, 1, 30.0, 64, 5
# the label_vad phase: 2 FLAC lectures of 170 s (one batch of chunks)
LABEL_VAD_FILES = 2
FINETUNE_BATCH = 8
# the packed phase: label_packed at large-v2, batch 16 over 24 speaker packs
# (2 batches, the second with 8 zero-audio pad rows), the model's whole
# 448-position budget, bf16 cross K/V; the packs come from 4 synthetic
# lectures of 120 s cut into utterances of 4-12 s under 2-3 speakers
PACK_BATCH, PACK_PACKS, PACK_BUDGET = 16, 24, 448
PACK_LECTURES, PACK_SECONDS = 4, 120.0
PACK_AGREE = 2  # packs of the base fp32 card-vs-CPU check
# the sweep phase: cli sweep --target distill over a grid of 2 learning
# rates, 2 steps at batch 8 a run
SWEEP_LRS, SWEEP_STEPS, SWEEP_BATCH = (1e-4, 1e-5), 2, 8
# the tensor_parallel phase (within 150 s): 2 ranks on the card at
# --model_parallel 2 over gloo, at the fp32 policy: distill 3 steps at
# batch 8 with a generation eval, finetune 2 steps (encoder trainable),
# greedy (fp8 cross K/V) and beam-5 decoding of 2 utterances
TP_RANKS, TP_STEPS, TP_FINETUNE_STEPS, TP_BATCH = 2, 3, 2, 8
TP_UTTS, TP_TOKENS = 2, 32
# the jobs of each set of TP_RANKS ranks; the sets run at once, beside the
# one-process jobs (gloo stages every all-reduce through the host: the
# ranks' jobs take 3-4x the one-process walls), which run largest first,
# while the ranks still load
TP_RANK_SETS = (("finetune",), ("distill",), ("decode",))
DISTILL_STEPS, FINETUNE_STEPS = 4, 3
CARD_BYTES = 76e9  # what a run may plan to hold of the card's 80 GB
SPIN_CYCLES = 10000  # the marker kernels at the ends of a device-time trace (~5 us)
# card vs CPU device VAD scorer (both fp32; cuFFT against pocketfft)
VAD_TOL = dict(energy_db=1e-2, flatness=1e-3, mod_ratio=1e-3)


def kernel_counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from taiwan_whisper_tpu_torch.ops import attention, decode_attention, layer_norm, mel_kernel

    return {"mel": mel_kernel.log10_mel_spectrum,
            "encoder_attention": attention.encoder_attention,
            "encoder_attention_bwd": attention.encoder_attention_backward,
            "decoder_attention": attention.decoder_attention,
            "cross_decode_attention": decode_attention.cross_attention,
            "self_decode_attention": decode_attention.self_attention,
            "layer_norm": layer_norm.layer_norm}


# a kernel's name in the kernels line -> its launch counter's key
COUNTER_OF = {"log_mel": "mel"}


def zero_counters():
    from taiwan_whisper_tpu_torch.ops import decode_attention

    for fn in kernel_counters().values():
        fn.launches = 0
    decode_attention.cross_attention.launches_by_rows = {}


def read_counters():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def add_launches(entries: dict, results: dict, path: str, launches: dict):
    """Record one main path's launch counts: per path in ``results``, and
    per kernel, summed and by path, in the kernels line."""
    results.setdefault("launches_by_path", {})[path] = launches
    for k, n in launches.items():
        e = entries.setdefault(k, {})
        e["launches"] = e.get("launches", 0) + n
        if n:
            e.setdefault("by_path", {})[path] = n


def log(msg: str):
    print(msg, flush=True)


def bound_ms(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, torch, iters: int = 10, flush=None) -> float:
    """Median milliseconds of ``fn()`` from CUDA events; ``flush`` (a large
    buffer) is rewritten before each launch so every launch finds L2 cold."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def loop_ms(fn, torch, iters: int = 20) -> float:
    """Mean milliseconds of ``fn()`` over back-to-back calls (CUDA events):
    the host runs ahead of the card, so this is device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(key: str, fn, torch, calls: int = 5, tries: int = 3) -> dict:
    """Device milliseconds per call of each kernel ``fn()`` launches, by
    kernel name (torch.profiler). CUPTI now and then misses a kernel at an
    end of the trace, so a short spin kernel (``torch.cuda._sleep``) before
    and after the calls takes that place and is left out. A trace in which
    a kernel was still not seen a whole number of times per call is taken
    again after a second's pause, up to ``tries`` traces, and the last
    one's shortfall raises (two retakes taken at once after a trace that
    lost kernels have both come back empty; the pause gives the profiler
    time to settle before the next)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        traced = {e.key: e for e in prof.key_averages() if e.self_device_time_total > 0}
        seen = {k: e for k, e in traced.items() if "spin_kernel" not in k}
        if seen and all(e.count % calls == 0 for e in seen.values()):
            return {k[:80]: e.self_device_time_total / 1e3 / calls for k, e in seen.items()}
        log(f"[kernel] {key}: trace {attempt} of {tries} holds "
            + (", ".join(f"{k[:80]} x{e.count}" for k, e in traced.items()) or "no kernel")
            + f" over {calls} calls")
        time.sleep(1.0)
    raise AssertionError(f"{key}: the profiler traced no whole set of the call's kernels "
                         f"in {tries} traces")


def host_us(fn, torch, calls: int = 200) -> float:
    """Host microseconds per call of ``fn()`` issued back to back: what the
    wrapper costs the host, the card's work queued behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_times(key: str, fn, library_fn, torch, checks: list, host: bool = False):
    """Back-to-back and per-kernel device times of a kernel's wrapper and,
    where one exists, of the PyTorch call that computes the same function,
    beside the flushed single calls ``record`` times. ``host``: also the
    host microseconds per wrapper call, and a second call whose output must
    be bitwise equal to the first (the decode kernels use no atomics)."""
    t = dict(loop_ms=loop_ms(fn, torch), kernels_ms=kernel_device_ms(key, fn, torch))
    if host:
        first, again = fn(), fn()
        t.update(host_us=host_us(fn, torch), bitwise_equal=torch.equal(first, again))
    if library_fn is not None:
        t.update(library_loop_ms=loop_ms(library_fn, torch),
                 library_kernels_ms=kernel_device_ms(key + " library", library_fn, torch))
    for side, who in (("", "kernel"), ("library_", "library")):
        if side + "loop_ms" in t:
            log(f"[kernel] {key} {who} back-to-back {t[side + 'loop_ms']:.4f} ms; "
                + ", ".join(f"{k} {ms:.4f}" for k, ms in t[side + "kernels_ms"].items()))
    if host:
        log(f"[kernel] {key} host {t['host_us']:.1f} us per call; a rerun bitwise equal: "
            f"{t['bitwise_equal']}")
    checks.append(dict(check=f"{key} device times", **t))
    if host and not t["bitwise_equal"]:
        raise AssertionError(f"{key}: a second call's output differs from the first")
    return t


def one_kernel(key: str, t: dict):
    """A wrapper's call must launch its kernel and nothing else (the log-mel
    wrapper no padding pass, the LayerNorm wrapper no cast): one kernel
    name in ``device_times``' trace."""
    if len(t["kernels_ms"]) != 1:
        raise AssertionError(f"{key}: the wrapper's call launched {sorted(t['kernels_ms'])}, "
                             f"not one kernel")


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (int(np.floor(np.log2(x))) - 7)


def max_abs(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def exports_max_abs(path_a: str, path_b: str):
    """(whether two fp32 safetensors files hold the same names and shapes,
    the largest |a - b| over their tensors or None), read through memory
    maps one tensor at a time: a 32-2 student's export is ~3 GB."""
    def layout(path):
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        return np.memmap(path, np.uint8, "r", offset=8 + n), header

    (ma, ha), (mb, hb) = layout(path_a), layout(path_b)
    if ha.keys() != hb.keys() or any(ha[k]["shape"] != hb[k]["shape"] or ha[k]["dtype"] != "F32"
                                     or hb[k]["dtype"] != "F32" for k in ha):
        return False, None
    err = 0.0
    for k in ha:
        (a0, a1), (b0, b1) = ha[k]["data_offsets"], hb[k]["data_offsets"]
        diff = np.abs(ma[a0:a1].view(np.float32) - mb[b0:b1].view(np.float32))
        err = max(err, float(diff.max()) if diff.size else 0.0)
    return True, err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def spill_bytes(name: str) -> int:
    """Bytes of spill stores and loads over every kernel of one library, from
    ptxas' lines in its build log."""
    from taiwan_whisper_tpu_torch.ops import _build

    return sum(int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                          _build.build_log(name)))


def phase_build():
    from taiwan_whisper_tpu_torch.ops import _build

    secs = _build.build_all()
    log(f"[build] {len(_build.sources())} kernel libraries in {secs:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ptxas.log"), "w", encoding="utf-8") as f:
        for name in _build.sources():
            f.write(f"== {name}\n{_build.build_log(name)}\n")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    log("[spills] " + ", ".join(f"{name} {spill_bytes(name)} bytes"
                                  for name in _build.sources()))
    # the encoder-attention kernels are built on Hopper's wgmma (HGMMA) and
    # TMA loads (UTMALDG), the decode kernels on 16-byte asynchronous copies
    # (LDGSTS): count them in the built code
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, ops in (("encoder_attention", ("HGMMA", "UTMALDG")),
                      ("encoder_attention_bwd", ("HGMMA", "UTMALDG")),
                      ("decode_attention", ("LDGSTS",))):
        if not os.path.exists(cuobjdump):
            log(f"[sass {name}] cuobjdump not found: {' / '.join(ops)} not counted")
            continue
        sass = subprocess.run([cuobjdump, "-sass", _build.library_path(name)],
                              capture_output=True, text=True, check=True).stdout
        counts = {op: sum(1 for line in sass.splitlines() if op in line) for op in ops}
        log(f"[sass {name}] " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if not all(counts.values()):
            raise AssertionError(f"{name}: an expected instruction is missing from the built "
                                 f"code: {counts}")
        if name == "encoder_attention":
            # the forward's bf16 template: the encoder's and the decoder's
            # cross-attention (CAUSAL false) and the decoder's causal one
            per_fn = sass_by_function(sass, ops)
            inst = {"causal" if "ILb1E" in fn else "non-causal": c
                    for fn, c in per_fn.items() if "attn_bf16" in fn}
            log(f"[sass {name}] by instantiation {json.dumps(inst)}")
            if set(inst) != {"causal", "non-causal"} or \
                    not all(all(c.values()) for c in inst.values()):
                raise AssertionError(f"{name}: a bf16 instantiation lacks HGMMA or UTMALDG or "
                                     f"is missing: {inst}")


def sass_by_function(sass: str, ops) -> dict:
    """Counts of the instructions ``ops`` in each function of a
    ``cuobjdump -sass`` listing, by mangled name."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += op in line
    return counts


DECODE_SRC = "taiwan_whisper_tpu_torch/csrc/decode_attention.cu"
CROSS_REP = "taiwan_whisper_tpu/ops/decode_attention.py:69"
SELF_REP = "taiwan_whisper_tpu/ops/decode_attention.py:132"


def cross_bound(q, k, kind=None):
    """Cross attention moves K and V once (packed int4: half a byte a
    position), q in and fp32 out; 4 operations per K/V position, d and
    query row, at q's type (``kind``: the "8x8" variant's int8)."""
    b, r, h, d = q.shape
    t = k.shape[-1] * (2 if str(k.dtype) == "torch.uint8" else 1)
    return bound_ms(2 * k.numel() * k.element_size() + q.numel() * q.element_size()
                    + b * r * h * d * 4, 4 * b * h * r * t * d,
                    kind or ("bf16" if q.dtype.itemsize == 2 else "fp32"))


def dequantized(DA, kq, dtype):
    """Stored K/V as ``dtype`` (packed int4 unpacked), the scale folded out."""
    if str(kq.dtype) == "torch.uint8":
        return DA.unpack_int4(kq, 2 * kq.shape[-1]).to(dtype)
    return kq.to(dtype)


def self_bound(q, index, vf):
    """Self attention moves the valid cache positions of K and V, q and the
    current token's k/v in, fp32 out (valid_from: the positions it leaves)."""
    b, h, d = q.shape
    valid = b * index if vf is None else int((index - vf.clamp(max=index)).sum())
    size = q.element_size()
    return bound_ms(2 * valid * h * d * size + 3 * b * h * d * size
                    + (0 if vf is None else b * 4) + b * h * d * 4,
                    4 * valid * h * d, "bf16" if size == 2 else "fp32")


def self_sdpa(torch, q, ck, cv, k_t, v_t, index, vf):
    """The one PyTorch call that computes self attention: SDPA of q over
    cache positions [lo, index] with the current token written at `index`
    (as the model's step does next) and a boolean mask for lo; returns the
    call, its inputs made beforehand."""
    import torch.nn.functional as F

    ck2, cv2 = ck.clone(), cv.clone()
    ck2[..., index], cv2[..., index] = k_t, v_t
    kh, vh = (x[..., :index + 1].transpose(-1, -2) for x in (ck2, cv2))
    pos = torch.arange(index + 1, device=q.device)
    lo = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device) if vf is None else vf
    mask = (pos[None] >= lo[:, None])[:, None, None, :]
    qh = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)


def cross_tile_cases(torch, DA, checks, record, g, flush, dev):
    """The cross kernel past one tile of 8 query rows, at large-v2 heads and
    the beam config's batch 8: ``TILE_ROWS`` rows on int8 storage (the beam
    config's cross-KV), on packed int4 and on bf16, against the plain
    version with the 1e-3 tolerance of the 1- and 3-row cases (fp32 output
    from the same inputs; a bf16 rounding of a probability may differ).
    Each case is timed flushed, back to back, per kernel and on the host,
    with a bitwise rerun, beside the plain version, SDPA over the
    (dequantized, for int8 and int4) bf16 K/V (library_ms; the dequantizing
    cast not counted) and an einsum of the dequantized K/V (logged). Then
    the label path's 1- and 3-row calls (fp8 and int4, batch 32), which run
    the one-tile code as before, bitwise against the same rows inside a
    15-row call: a tile computes its rows exactly as a call of those rows
    alone."""
    import torch.nn.functional as F

    D, T, H, b, bf16 = 64, 1500, 20, BEAM_BATCH, torch.bfloat16
    base = torch.randn((b, H, D, T), generator=g, device=dev)
    int8 = torch.randint(-127, 128, base.shape, generator=g, device=dev, dtype=torch.int8)
    int4 = DA.pack_int4(torch.randint(-7, 8, base.shape, generator=g, device=dev,
                                      dtype=torch.int8))
    stores = {"int8": (int8, int8, 0.002, 1 / 127), "int4": (int4, int4, 0.036, 1 / 7),
              "bf16": (base.to(bf16), (base * 0.5).to(bf16), 0.125, 1.0)}
    for store, (kq, vq, q_scale, v_scale) in stores.items():
        kq, vq = DA.time_minor_copy(kq), DA.time_minor_copy(vq)
        # the dequantized K/V (its scale folds out)
        kd, vd = dequantized(DA, kq, bf16), dequantized(DA, vq, bf16)
        kh, vh = kd.transpose(-1, -2), vd.transpose(-1, -2)
        for rows in TILE_ROWS:
            qs = (torch.randn((b, rows, H, D), generator=g, device=dev) * q_scale).to(bf16)
            qh = qs.transpose(1, 2)
            key = f"cross_attention[bfloat16 q,{store},rows={rows},B={b}]"

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)

            def einsum():
                probs = torch.softmax(torch.einsum("bqhd,bhdt->bhqt", qs, kd).float(), dim=-1)
                return torch.einsum("bhqt,bhdt->bqhd", probs.to(bf16), vd)

            record(key, "cross_decode_attention", DECODE_SRC, CROSS_REP,
                   DA.cross_attention(qs, kq, vq, T) * v_scale,
                   DA.cross_attention_plain(qs, kq, vq, T) * v_scale, 1e-3,
                   time_ms(lambda: DA.cross_attention(qs, kq, vq, T), torch, flush=flush),
                   time_ms(lambda: DA.cross_attention_plain(qs, kq, vq, T), torch, iters=5,
                           flush=flush),
                   cross_bound(qs, kq), time_ms(sdpa, torch, flush=flush))
            einsum_ms = time_ms(einsum, torch, flush=flush)
            log(f"[kernel] {key} einsum of the dequantized K/V {einsum_ms:.4f} ms flushed")
            checks.append(dict(check=f"{key} einsum", einsum_ms=einsum_ms))
            device_times(key, lambda: DA.cross_attention(qs, kq, vq, T), sdpa, torch, checks,
                         host=True)
    B = LARGE_V2_BATCH
    base = torch.randn((B, H, D, T), generator=g, device=dev)
    i4 = torch.randint(-7, 8, base.shape, generator=g, device=dev, dtype=torch.int8)
    for store, (k, v, q_scale) in {
            "fp8": ((base * 50).to(torch.float8_e4m3fn), (base * 25).to(torch.float8_e4m3fn),
                    0.0025),
            "int4": (DA.pack_int4(i4), DA.pack_int4(i4.flip(-1)), 0.036)}.items():
        kq, vq = DA.time_minor_copy(k), DA.time_minor_copy(v)
        q15 = (torch.randn((B, 15, H, D), generator=g, device=dev) * q_scale).to(bf16)
        out15 = DA.cross_attention(q15, kq, vq, T)
        same = {f"rows {r.start}-{r.stop - 1}": torch.equal(
            DA.cross_attention(q15[:, r].contiguous(), kq, vq, T), out15[:, r])
            for r in (slice(0, 1), slice(0, 3), slice(8, 11))}
        log(f"[kernel] cross {store} B={B}: 1- and 3-row calls bitwise equal to the same rows "
            f"of a 15-row call: {same}")
        checks.append(dict(check=f"cross_attention tiles bitwise[{store}]", **same))
        if not all(same.values()):
            raise AssertionError(f"the cross kernel's tiles differ from calls of their rows "
                                 f"({store}): {same}")


def int8_dots_cases(torch, DA, checks, record, g, flush, dev):
    """The cross kernel's "8x8" variant (fp32 q quantized to int8 per row,
    int8 x int8 scores and P V with int8 probabilities) on int8 storage at
    the greedy path's shape (large-v2, batch 32, 1 row) and the beam path's
    (batch 8, 5 rows), against its plain version (the JAX formula in torch,
    the integer sums exact in fp64). The integer products are exact on both
    sides, so they differ only where a probability lands within an fp32 ulp
    of a rounding boundary of p8 and rounds the other way: one such flip
    moves an output of row (b, r, h) by at most max|V x scale| x pmax / 127,
    with pmax that row's largest probability in the plain version (about
    1e-2 over these 1500 fairly flat positions) and the V maximum taken per
    (b, h). Each output is held to 4 such steps of its own row, and at most
    1% of the (b, r, h) rows may hold an output more than 1e-6 from the
    plain version (a flip moves a row by ~1e-5 or more; every earlier run
    read a largest error under 6e-8). A kernel that floors p8 instead of
    rounding it errs by ~15 steps in a typical row and fails both. Timed as
    the other cases, SDPA over the dequantized bf16 K/V as the library."""
    import torch.nn.functional as F

    D, T, H = 64, 1500, 20
    for b, rows in ((LARGE_V2_BATCH, 1), (BEAM_BATCH, BEAMS)):
        kq, vq = (DA.time_minor_copy(torch.randint(-127, 128, (b, H, D, T), generator=g,
                                                   device=dev, dtype=torch.int8))
                  for _ in range(2))
        v_scale = 1 / 127
        q = torch.randn((b, rows, H, D), generator=g, device=dev) * 0.002
        kh, vh = (dequantized(DA, x, torch.bfloat16).transpose(-1, -2) for x in (kq, vq))
        qh = q.to(torch.bfloat16).transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)

        got = DA.cross_attention_int8_dots(q, kq, vq) * v_scale
        ref = DA.cross_attention_int8_dots_plain(q, kq, vq) * v_scale
        # one p8 step of each row [b, r, h, 1], from the plain version's pmax
        q8, qmax = DA.quantize_rows_int8(q)
        logits = (torch.einsum("bqhd,bhdt->bhqt", q8.double(), kq.double()).float()
                  * (qmax / 127.0).permute(0, 2, 1, 3))
        pmax = torch.softmax(logits, dim=-1).amax(dim=-1) + 1e-12  # [b, h, r]
        vmax = vq.float().abs().amax(dim=(-2, -1)) * v_scale  # [b, h]
        step = (vmax[:, :, None] * pmax / 127).permute(0, 2, 1)[..., None]
        diff = (got - ref).abs()
        worst = float((diff / step).max())
        rows_off = int((diff > 1e-6).any(dim=-1).sum())
        n_rows = b * rows * H
        key = f"cross_attention[8x8,rows={rows},B={b}]"
        log(f"[kernel] {key}: largest error {worst:.3g} p8 steps of its row (limit 4; one "
            f"step {float(step.min()):.3g} to {float(step.max()):.3g}); {rows_off} of {n_rows} "
            f"rows hold an output more than 1e-6 from the plain version (limit {n_rows // 100})")
        checks.append(dict(check=f"{key} p8 steps", worst_steps=worst, rows_off=rows_off,
                           rows=n_rows, step_min=float(step.min()), step_max=float(step.max())))
        if not worst <= 4 or rows_off > n_rows // 100:
            raise AssertionError(f"{key}: {worst:.3g} p8 steps off (limit 4), {rows_off} of "
                                 f"{n_rows} rows off by more than 1e-6 (limit {n_rows // 100})")
        # the loosest row's limit; every output was held to its own row's above
        record(key, "cross_decode_attention", DECODE_SRC, CROSS_REP, got, ref,
               4 * float(step.max()),
               time_ms(lambda: DA.cross_attention_int8_dots(q, kq, vq), torch, iters=20,
                       flush=flush),
               time_ms(lambda: DA.cross_attention_int8_dots_plain(q, kq, vq), torch, iters=3,
                       flush=flush),
               cross_bound(q, kq, "int8"), time_ms(sdpa, torch, flush=flush))
        device_times(key, lambda: DA.cross_attention_int8_dots(q, kq, vq), sdpa, torch, checks,
                     host=True)


def extend_cross_case(torch, DA, checks, record, g, flush, dev):
    """The cross kernel as ``extend`` launches it in speculative decoding at
    large-v2: batch 1, 6 query rows (the teacher's pick and 5 drafts), bf16
    q over bf16 storage [1, 20, 64, 1500] (unquantized, as in JAX);
    tolerance 1e-3 as the other bf16 cases, SDPA over the same K/V."""
    import torch.nn.functional as F

    D, T, H = 64, 1500, 20
    k, v = (DA.time_minor_copy(torch.randn((1, H, D, T), generator=g, device=dev)
                               .to(torch.bfloat16)) for _ in range(2))
    q = (torch.randn((1, 6, H, D), generator=g, device=dev) * 0.125).to(torch.bfloat16)
    qh, kh, vh = q.transpose(1, 2), k.transpose(-1, -2), v.transpose(-1, -2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)

    key = "cross_attention[bfloat16 q,bf16,rows=6,B=1]"
    record(key, "cross_decode_attention", DECODE_SRC, CROSS_REP, DA.cross_attention(q, k, v),
           DA.cross_attention_plain(q, k, v), 1e-3,
           time_ms(lambda: DA.cross_attention(q, k, v), torch, iters=20, flush=flush),
           time_ms(lambda: DA.cross_attention_plain(q, k, v), torch, flush=flush),
           cross_bound(q, k), time_ms(sdpa, torch, flush=flush))
    device_times(key, lambda: DA.cross_attention(q, k, v), sdpa, torch, checks, host=True)


def decode_edge_cases(torch, DA, checks, g, dev):
    """The decode kernels away from the main path's layout: a cross K/V
    that is contiguous, not row-padded (fp8 rows of 1500 bytes cannot take
    16-byte copies: the wrapper must refuse them with its message; fp32 rows
    of 6000 bytes can: the kernel must take them), and batch 1 (a grid of
    20 clusters, less than one wave). Tolerances as in phase_kernels; the
    launch counters are zeroed first and must count exactly the accepted
    launches."""
    D, T, H = 64, 1500, 20
    zero_counters()
    base = torch.randn((4, 8, D, T), generator=g, device=dev)
    k8, v8 = (base * 50).to(torch.float8_e4m3fn), (base * 25).to(torch.float8_e4m3fn)
    q = (torch.randn((4, 1, 8, D), generator=g, device=dev) * 0.0025).to(torch.bfloat16)
    try:
        DA.cross_attention(q, k8, v8)
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"[kernel] cross_attention on contiguous fp8 rows of {T} bytes: refused: {refused}")
    if refused is None or "16 bytes" not in refused:
        raise AssertionError("the wrapper took fp8 K/V rows that are not on 16 bytes")
    cases = {"fp32 contiguous rows": (torch.randn((4, 1, 8, D), generator=g, device=dev) * 0.125,
                                      base, base * 0.5, 1.0, 1e-5)}
    b1 = torch.randn((1, H, D, T), generator=g, device=dev)
    for rows in (1, 3):
        cases[f"B=1,rows={rows}"] = (
            (torch.randn((1, rows, H, D), generator=g, device=dev) * 0.0025).to(torch.bfloat16),
            DA.time_minor_copy((b1 * 50).to(torch.float8_e4m3fn)),
            DA.time_minor_copy((b1 * 25).to(torch.float8_e4m3fn)), 1 / 25, 1e-3)
    for key, (q, k, v, v_scale, tol) in cases.items():
        err = max_abs(DA.cross_attention(q, k, v) * v_scale,
                      DA.cross_attention_plain(q, k, v) * v_scale)
        log(f"[kernel] cross_attention edge {key} k strides {k.stride()}: err {err:.3g} "
            f"(tol {tol:g})")
        checks.append(dict(check=f"cross_attention_edge[{key}]", max_abs_err=err, tolerance=tol))
        if not err <= tol:
            raise AssertionError(f"cross attention edge case {key}: err {err:.3g} > {tol:g}")
    ck, cv = (DA.time_minor_copy(torch.randn((1, H, D, 195), generator=g, device=dev)
                                 .to(torch.bfloat16)) for _ in range(2))
    q, k_t, v_t = (torch.randn((1, H, D), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
    q = q * 0.125
    err = max_abs(DA.self_attention(q, ck, cv, k_t, v_t, 194),
                  DA.self_attention_plain(q, ck, cv, k_t, v_t, 194, None))
    log(f"[kernel] self_attention edge B=1, index 194: err {err:.3g} (tol 1e-3)")
    checks.append(dict(check="self_attention_edge[B=1]", max_abs_err=err, tolerance=1e-3))
    if not err <= 1e-3:
        raise AssertionError(f"self attention at B=1: err {err:.3g} > 1e-3")
    launches = read_counters()
    expected = dict({k: 0 for k in launches}, cross_decode_attention=len(cases),
                    self_decode_attention=1)
    log(f"[kernel] decode edge launches {json.dumps(launches)} expected "
        f"{json.dumps(expected)}")
    if launches != expected:
        raise AssertionError(f"decode edge-case launch counts {launches} != expected {expected}")


def phase_kernels(torch, entries: dict, checks: list, case_rows: list, only=None):
    """Every kernel variant a driven path launches, held against its plain
    version: the label path's (large-v2, batch 32, bf16, fp8 cross-KV), the
    prefilter's (whisper-base, batch 64, bf16, unquantized cross-KV, a
    448-position cache) and the agree phase's (base, batch 4, fp32 policy).
    ``only``: just these
    groups' main cases ("mel", "layer_norm"), which call nothing but the
    public wrappers (an A/B runs them against another tree's package)."""
    import torch.nn.functional as F

    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.ops import attention as EA
    from taiwan_whisper_tpu_torch.ops import decode_attention as DA

    dev = resolve_device("cuda")  # TF32 off: the fp32 plain versions stay fp32
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    B, H, D, T = LARGE_V2_BATCH, 20, 64, 1500
    AB, AH, AS = AGREE_BATCH, 8, 3 + AGREE_TOKENS  # the agree phase's shapes (base)
    bf16, f32 = torch.bfloat16, torch.float32

    def record(key, name, source, replaces, got, ref, tol, ms, plain_ms, bnd, library_ms):
        err = max_abs(got, ref)
        ref_max = float(ref.float().abs().max())
        if not err <= tol:
            raise AssertionError(f"{key}: max abs err {err:.3g} > tolerance {tol:g} "
                                 f"(max |plain| {ref_max:.3g})")
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms)
        case_rows.append(dict(row, case=key))
        checks.append(dict(check=key, ref_max_abs=ref_max, **{
            k: row[k] for k in ("max_abs_err", "tolerance", "ms", "plain_ms")}))
        log(f"[kernel] {key}: err {err:.3g} (tol {tol:g}, max |plain| {ref_max:.3g}) "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"library {library_ms}")
        return row

    if only is not None:
        if "mel" in only:
            mel_cases(torch, entries, checks, record, g, flush)
        if "layer_norm" in only:
            layer_norm_cases(torch, entries, checks, record, g, flush)
        return
    for name in ("mel", "layer_norm"):
        if spill_bytes(name) != 0:
            raise AssertionError(f"{name}: ptxas spilled {spill_bytes(name)} bytes")
    one_kernel("mel", mel_cases(torch, entries, checks, record, g, flush))

    # 2. encoder attention. bf16 [32, 1500, 20, 64] with unit-variance
    # q/k/v: with the in-kernel 1/8 scale the scores have std 1 over 1500
    # keys, so each output is a diffuse average, |out| ~0.04 typical and
    # at most ~0.5-1 over the 61 M outputs. Tolerance 8e-3, two bf16 ulps
    # at [0.5, 1): both sides round the output to bf16 from fp32 sums taken
    # in another order, and round probabilities to bf16 at another scale
    # (unnormalised in the kernel). A diffuse average hides a mis-weighted
    # key tile, so the same kernel is also held at q x 4, v / 4 (score std
    # 4): attention peaks on a few keys, |out| is O(0.1-1), up to ~1.3, and
    # a dropped or mis-weighted tile moves outputs by O(0.1). Tolerance
    # 2e-2: the probability rounding (2^-9 of the output, ~3e-3) plus one
    # bf16 ulp at [1, 2) (7.8e-3) from the final rounding, with room to
    # spare. fp32 [4, 1500, 8, 64] (the SIMT kernel of the agree phase's
    # fp32 policy): tolerance 1e-5, fp32 throughout, outputs < 1.
    enc_src, enc_rep = ("taiwan_whisper_tpu_torch/csrc/encoder_attention.cu",
                        "taiwan_whisper_tpu/ops/attention.py:71")
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev).to(bf16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    enc_bound = bound_ms(4 * B * T * H * D * 2, 4 * B * H * T * T * D, "bf16")
    entries["encoder_attention"] = record(
        "encoder_attention[bf16]", "encoder_attention", enc_src, enc_rep,
        EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v), 8e-3,
        time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
        time_ms(lambda: EA.attention_plain(q, k, v), torch, iters=3, flush=flush),
        enc_bound,
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, flush=flush))
    device_times("encoder_attention[bf16]", lambda: EA.encoder_attention(q, k, v),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, checks)
    q4, v4 = (q.float() * 4).to(bf16), (v.float() / 4).to(bf16)  # exact in bf16
    record("encoder_attention[bf16,peaked]", "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q4, k, v4), EA.attention_plain(q4, k, v4), 2e-2,
           time_ms(lambda: EA.encoder_attention(q4, k, v4), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q4, k, v4), torch, iters=3, flush=flush),
           enc_bound, None)
    del q, k, v, qt, kt, vt, q4, v4
    # the prefilter's validator (whisper-base): bf16 [64, 1500, 8, 64], rows
    # of 1024 bytes in the TMA maps; unit inputs, tolerance 8e-3 as above
    PB, PH = PREFILTER_BATCH, 8
    q, k, v = (torch.randn((PB, T, PH, D), generator=g, device=dev).to(bf16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    key = f"encoder_attention[bf16,B={PB},H={PH}]"
    record(key, "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v), 8e-3,
           time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q, k, v), torch, iters=3, flush=flush),
           bound_ms(4 * PB * T * PH * D * 2, 4 * PB * PH * T * T * D, "bf16"),
           time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, flush=flush))
    device_times(key, lambda: EA.encoder_attention(q, k, v),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, checks)
    del q, k, v, qt, kt, vt
    # label_packed's batch: bf16 [16, 1500, 20, 64]; unit inputs, tolerance 8e-3
    q, k, v = (torch.randn((PACK_BATCH, T, H, D), generator=g, device=dev).to(bf16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    key = f"encoder_attention[bf16,B={PACK_BATCH},H={H}]"
    record(key, "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v), 8e-3,
           time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q, k, v), torch, iters=3, flush=flush),
           bound_ms(4 * PACK_BATCH * T * H * D * 2, 4 * PACK_BATCH * H * T * T * D, "bf16"),
           time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, flush=flush))
    device_times(key, lambda: EA.encoder_attention(q, k, v),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, checks)
    del q, k, v, qt, kt, vt
    # tensor parallel: a model rank's local heads at the distill / finetune
    # batch, 10 of large-v2's 20 at --model_parallel 2 and 5 at 4 (bf16,
    # unit inputs, tolerance 8e-3 as above), and the fp32 kernel at 10
    # heads, which the tensor_parallel phase's fp32 runs launch (tolerance
    # 1e-5 as for the agree phase's)
    for h, dtype in ((H // 2, bf16), (H // 4, bf16), (H // 2, f32)):
        q, k, v = (torch.randn((TP_BATCH, T, h, D), generator=g, device=dev).to(dtype)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kind = str(dtype)[6:]
        key = f"encoder_attention[{kind},B={TP_BATCH},H={h}]"
        record(key, "encoder_attention", enc_src, enc_rep,
               EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v),
               8e-3 if dtype == bf16 else 1e-5,
               time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
               time_ms(lambda: EA.attention_plain(q, k, v), torch, iters=3, flush=flush),
               bound_ms(4 * TP_BATCH * T * h * D * q.element_size(),
                        4 * TP_BATCH * h * T * T * D, "bf16" if dtype == bf16 else "fp32"),
               time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, flush=flush))
        if dtype == bf16:
            device_times(key, lambda: EA.encoder_attention(q, k, v),
                         lambda: F.scaled_dot_product_attention(qt, kt, vt), torch, checks)
        del q, k, v, qt, kt, vt
    q, k, v = (torch.randn((AB, T, AH, D), generator=g, device=dev) for _ in range(3))
    record("encoder_attention[fp32,agree]", "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v), 1e-5,
           time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q, k, v), torch, flush=flush),
           bound_ms(4 * AB * T * AH * D * 4, 4 * AB * AH * T * T * D, "fp32"), None)
    del q, k, v

    # 2f-2g. the decoder attention of distillation's teacher (decode_train
    # under no_grad), bf16 at batch 32 x 20 heads over U = 448 tokens:
    # causal self-attention [32, 448, 20, 64] and cross-attention of those
    # queries over [32, 1500, 20, 64]. Cross, as the encoder's row 2: unit
    # inputs, a diffuse average over 1500 keys (|out| < 1), tolerance 8e-3;
    # peaked (q x 4, v / 4), tolerance 2e-2. Causal rows are short at the
    # top (row i averages i + 1 keys: row 0 is v[0] itself), so they are
    # peaked by construction: v / 4 keeps |out| within ~1.3 as the
    # encoder's peaked case does, and both causal cases (unit q, q x 4)
    # take its tolerance, 2e-2. Bounds count the work the mask keeps
    # (S(S+1)/2 query-key pairs), q/k/v read once and out written once.
    dec_rep = "taiwan_whisper_tpu/models/whisper.py::_attention (XLA einsums; no Pallas kernel)"
    U = DISTILL_TOKENS
    q = torch.randn((B, U, H, D), generator=g, device=dev).to(bf16)
    ks, vs = (torch.randn((B, U, H, D), generator=g, device=dev).to(bf16) for _ in range(2))
    kc, vc = (torch.randn((B, T, H, D), generator=g, device=dev).to(bf16) for _ in range(2))
    vs4, vc4 = (vs.float() / 4).to(bf16), (vc.float() / 4).to(bf16)  # exact in bf16
    q4 = (q.float() * 4).to(bf16)
    tril = torch.tril(torch.ones(U, U, dtype=torch.bool, device=dev))[None, None]
    causal_bound = bound_ms(4 * B * U * H * D * 2, 4 * B * H * D * U * (U + 1) // 2, "bf16")
    cross_bound_ms = bound_ms((2 * B * U * H * D + 2 * B * T * H * D) * 2, 4 * B * H * U * T * D,
                              "bf16")
    for tag, qq, kk, vv, causal, tol, bnd in (
            ("causal", q, ks, vs4, True, 2e-2, causal_bound),
            ("causal,peaked", q4, ks, vs4, True, 2e-2, causal_bound),
            ("cross", q, kc, vc, False, 8e-3, cross_bound_ms),
            ("cross,peaked", q4, kc, vc4, False, 2e-2, cross_bound_ms)):
        mask = tril if causal else None
        qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
        key = f"decoder_attention[bf16,{tag}]"

        def kernel(qq=qq, kk=kk, vv=vv, causal=causal):
            return EA.decoder_attention(qq, kk, vv, causal=causal)

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        row = record(key, "decoder_attention", enc_src, dec_rep, kernel(),
                     EA.attention_plain(qq, kk, vv, mask), tol,
                     time_ms(kernel, torch, flush=flush),
                     time_ms(lambda: EA.attention_plain(qq, kk, vv, mask), torch, iters=3,
                             flush=flush),
                     bnd, time_ms(sdpa, torch, flush=flush))
        if tag == "cross":
            entries["decoder_attention"] = row
        if "peaked" not in tag:
            device_times(key, kernel, sdpa, torch, checks)
        del qt, kt, vt
    del q, q4, ks, vs, kc, vc, vs4, vc4, tril

    # 3. cross attention over one layer's time-minor K/V [B, H, 64, 1500]
    # in row-padded storage (as the model keeps it), 1 query row (decode
    # step) and 3 (prefill): bf16 q with bf16/int8/fp8 storage at the label
    # path's shapes, fp32 q with fp32/int8/fp8 storage at the agree phase's.
    # q is scaled so the scores have unit spread, as in the model; the error
    # is read after the V scale the model applies next (dequantized output,
    # O(1)). Tolerance 1e-3 for bf16 q: fp32 output from identical inputs;
    # the probabilities are rounded to bf16 on both sides, and a fp32
    # summation-order difference can move one across a bf16 rounding
    # boundary. Tolerance 1e-5 for fp32 q: nothing is rounded below fp32,
    # only the summation order differs. The label path's cases (bf16 q, fp8
    # storage, 1 and 3 rows) and the prefilter's (bf16 storage, base at
    # batch 64) are also timed back to back, per kernel and on the host,
    # with a bitwise rerun.
    def cross_cases(b, h, q_dtype, stores, tol, entry, timed=("fp8",), tag="", n_rows=(1, 3)):
        base = torch.randn((b, h, D, T), generator=g, device=dev)
        for store, (kq, vq, q_scale, v_scale) in stores(base).items():
            kq, vq = DA.time_minor_copy(kq), DA.time_minor_copy(vq)
            for rows in n_rows:
                qs = (torch.randn((b, rows, h, D), generator=g, device=dev)
                      * q_scale).to(q_dtype)
                # the library: SDPA over the K/V in q's dtype (quantized
                # storage dequantized beforehand, the scales folded out)
                qh = qs.transpose(1, 2)
                kh, vh = (dequantized(DA, x, q_dtype).transpose(-1, -2) for x in (kq, vq))

                def sdpa():
                    return F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)

                lib = time_ms(sdpa, torch, flush=flush)
                key = f"cross_attention[{str(q_dtype)[6:]} q,{store},rows={rows}{tag}]"
                row = record(
                    key, "cross_decode_attention", DECODE_SRC, CROSS_REP,
                    DA.cross_attention(qs, kq, vq, T) * v_scale,
                    DA.cross_attention_plain(qs, kq, vq, T) * v_scale, tol,
                    time_ms(lambda: DA.cross_attention(qs, kq, vq, T), torch, iters=20,
                            flush=flush),
                    time_ms(lambda: DA.cross_attention_plain(qs, kq, vq, T), torch, flush=flush),
                    cross_bound(qs, kq), lib)
                if q_dtype == bf16 and store in timed:
                    device_times(key, lambda: DA.cross_attention(qs, kq, vq, T), sdpa, torch,
                                 checks, host=True)
                del qh, kh, vh
                if (store, rows) == entry:
                    entries["cross_decode_attention"] = row

    def quantized(base):
        return {"int8": (torch.randint(-127, 128, base.shape, generator=g, device=dev,
                                       dtype=torch.int8),) * 2 + (0.002, 1 / 127),
                "fp8": ((base * 50).to(torch.float8_e4m3fn),
                        (base * 25).to(torch.float8_e4m3fn), 0.0025, 1 / 25),
                # packed int4 (two positions a byte): scores of the same spread
                "int4": (DA.pack_int4(torch.randint(-7, 8, base.shape, generator=g, device=dev,
                                                    dtype=torch.int8)),) * 2 + (0.036, 1 / 7)}

    # fp8 with 1 row is what each label decode step runs; int4 with 1 row
    # each step of the --quantize_kv 4 label run
    cross_cases(B, H, bf16, lambda base: {
        "bf16": (base.to(bf16), (base * 0.5).to(bf16), 0.125, 1.0), **quantized(base)},
        1e-3, ("fp8", 1), timed=("fp8", "int4"))
    cross_cases(AB, AH, f32, lambda base: {
        "fp32": (base, base * 0.5, 0.125, 1.0), **quantized(base)}, 1e-5, None)
    # the prefilter's validator: bf16 storage (unquantized cross K/V, C = 4)
    cross_cases(PB, PH, bf16, lambda base: {"bf16": (base.to(bf16), (base * 0.5).to(bf16),
                                                     0.125, 1.0)},
                1e-3, None, timed=("bf16",), tag=f",B={PB},H={PH}")
    # label_packed: bf16 storage (unquantized cross K/V) at large-v2, batch 16
    cross_cases(PACK_BATCH, H, bf16, lambda base: {"bf16": (base.to(bf16),
                                                            (base * 0.5).to(bf16), 0.125, 1.0)},
                1e-3, None, timed=("bf16",), tag=f",B={PACK_BATCH},H={H}")
    # tensor parallel: a model rank's 10 heads at the distill batch, 1 row
    # (a greedy step) and 5 (a beam-5 step): bf16 q on bf16 and fp8 storage
    # (a bf16 run's), fp32 q on fp32 and fp8 storage (the tensor_parallel
    # phase's fp32 generation eval and decodes)
    cross_cases(TP_BATCH, H // 2, bf16, lambda base: {
        "bf16": (base.to(bf16), (base * 0.5).to(bf16), 0.125, 1.0),
        "fp8": quantized(base)["fp8"]}, 1e-3, None, timed=("bf16", "fp8"),
        tag=f",B={TP_BATCH},H={H // 2}", n_rows=(1, BEAMS))
    cross_cases(TP_BATCH, H // 2, f32, lambda base: {
        "fp32": (base, base * 0.5, 0.125, 1.0), "fp8": quantized(base)["fp8"]}, 1e-5, None,
        timed=(), tag=f",B={TP_BATCH},H={H // 2}", n_rows=(1, BEAMS))
    cross_tile_cases(torch, DA, checks, record, g, flush, dev)
    int8_dots_cases(torch, DA, checks, record, g, flush, dev)
    extend_cross_case(torch, DA, checks, record, g, flush, dev)

    # 4. self attention over the cache [B, H, 64, S] (row-padded) at the
    # last step (index S - 1): bf16 at the label path's shapes with no
    # valid_from (what the label path passes: the kernel's null-pointer
    # branch) and with a mixed valid_from; fp32 at the agree phase's shapes
    # with no valid_from. Tolerances 1e-3 (bf16) and 1e-5 (fp32) as for
    # cross. The label path's case is also held at index 3 and 97 (a step
    # early and half way through the budget); it and the prefilter's cases
    # (bf16, no valid_from) are timed back to back, per kernel and on the
    # host, with a bitwise rerun; their library yardstick
    # is SDPA over the same cache positions with the current token written
    # at `index` (it does not round P to bf16 before P V, so it differs from
    # the plain version by more than the tolerance: logged, not held).
    def self_case(b, h, s, dtype, vf, tol, index=None, tag=""):
        index = s - 1 if index is None else index
        ck, cv = (DA.time_minor_copy(torch.randn((b, h, D, s), generator=g, device=dev)
                                     .to(dtype)) for _ in range(2))
        qs, k_t, v_t = (torch.randn((b, h, D), generator=g, device=dev).to(dtype)
                        for _ in range(3))
        qs = qs * 0.125
        key = (f"self_attention[{str(dtype)[6:]},valid_from={'none' if vf is None else 'mixed'},"
               f"index={index}{tag}]")
        label_path = dtype == bf16 and vf is None
        plain = DA.self_attention_plain(qs, ck, cv, k_t, v_t, index, vf)
        sdpa = lib = None
        if label_path:
            sdpa = self_sdpa(torch, qs, ck, cv, k_t, v_t, index, vf)
            lib = time_ms(sdpa, torch, flush=flush)
            log(f"[kernel] {key} SDPA differs from the plain version by "
                f"{max_abs(sdpa().reshape(plain.shape), plain):.3g}")
        row = record(
            key, "self_decode_attention", DECODE_SRC, SELF_REP,
            DA.self_attention(qs, ck, cv, k_t, v_t, index, vf), plain, tol,
            time_ms(lambda: DA.self_attention(qs, ck, cv, k_t, v_t, index, vf), torch,
                    iters=20, flush=flush),
            time_ms(lambda: DA.self_attention_plain(qs, ck, cv, k_t, v_t, index, vf), torch,
                    flush=flush),
            self_bound(qs, index, vf), lib)
        if label_path:
            device_times(key, lambda: DA.self_attention(qs, ck, cv, k_t, v_t, index, vf), sdpa,
                         torch, checks, host=True)
        return row

    S = 3 + MAX_DECODE_TOKENS
    entries["self_decode_attention"] = self_case(B, H, S, bf16, None, 1e-3)
    for index in (3, 97):
        self_case(B, H, S, bf16, None, 1e-3, index)
    self_case(B, H, S, bf16, torch.randint(0, 3, (B,), generator=g, device=dev,
                                           dtype=torch.int32), 1e-3)
    self_case(AB, AH, AS, f32, None, 1e-5)
    # the prefilter's validator: a 448-position cache; index 447 splits over
    # a 4-block cluster, 200 and 3 run one block
    for index in (PREFILTER_BUDGET - 1, 200, 3):
        self_case(PB, PH, PREFILTER_BUDGET, bf16, None, 1e-3, index, tag=f",B={PB},H={PH}")
    # label_packed: large-v2 at batch 16 over the whole 448-position budget
    for index in (PACK_BUDGET - 1, 200, 3):
        self_case(PACK_BATCH, H, PACK_BUDGET, bf16, None, 1e-3, index,
                  tag=f",B={PACK_BATCH},H={H}")
    # the beam label path: the beams are batch rows to the self kernel, B x K
    # = 40, at the last step of its budget
    self_case(BEAM_BATCH * BEAMS, H, 3 + BEAM_TOKENS, bf16, None, 1e-3,
              tag=f",B={BEAM_BATCH}x{BEAMS}")
    # tensor parallel: a model rank's 10 heads at the distill batch over the
    # generation eval's budget (3 + 128 positions), bf16 and fp32
    for dtype, tol in ((bf16, 1e-3), (f32, 1e-5)):
        self_case(TP_BATCH, H // 2, 3 + 128, dtype, None, tol, tag=f",B={TP_BATCH},H={H // 2}")
    attention_backward_cases(torch, entries, checks, record, g, flush)
    for key, t in layer_norm_cases(torch, entries, checks, record, g, flush).items():
        one_kernel(key, t)
    layer_norm_edge_cases(torch, checks, g, dev)
    decode_edge_cases(torch, DA, checks, g, dev)


def mel_bound(b: int, n: int, m: int):
    """The least time of the log-mel function, whatever computes it: the
    audio read once and the log-mel written once; per frame a 400-point
    real FFT (2.5 N log2 N flop), the power (3 flop a bin) and the mel
    product over the filter bank's nonzeros (2 flop each), at fp32."""
    from taiwan_whisper_tpu_torch.audio import mel as A

    frames = b * (n // A.HOP_LENGTH)
    nnz = int(np.count_nonzero(A.mel_filter_bank(m)))
    per_frame = 2.5 * A.N_FFT * np.log2(A.N_FFT) + 3 * A.N_FREQS + 2 * nnz
    return bound_ms(4 * (b * n + frames * m), frames * per_frame, "fp32")


def mel_cases(torch, entries, checks, record, g, flush):
    """The log-mel kernel at the label path's shape (32 x 30 s, 80 mels),
    once with 128 mels (batch 4) and at the prefilter's batch of 64, on
    Gaussian audio. Tolerance 1e-4 on
    the normalised log-mel: fp32 throughout; the FFT sums in another order
    than the plain version's DFT products and takes log10 through the
    hardware's log2 (2.7e-5 apart on the H100). The 80-mel cases are also
    timed back to back, per kernel and on the host, with a bitwise rerun;
    returns the label case's times."""
    from taiwan_whisper_tpu_torch.audio import mel as A
    from taiwan_whisper_tpu_torch.ops import mel_kernel as MK

    dev = flush.device
    src, rep = "taiwan_whisper_tpu_torch/csrc/mel.cu", "taiwan_whisper_tpu/ops/mel_kernel.py:60"
    for b, m in ((LARGE_V2_BATCH, 80), (AGREE_BATCH, 128), (PREFILTER_BATCH, 80),
                 (PACK_BATCH, 80)):
        audio = torch.randn((b, A.N_SAMPLES), generator=g, device=dev) * 0.1
        key = {LARGE_V2_BATCH: "mel", AGREE_BATCH: f"mel[{m} mels]"}.get(b, f"mel[b{b}]")
        row = record(
            key, "log_mel", src, rep, MK.log_mel(audio, m), A.log_mel(audio, m), 1e-4,
            time_ms(lambda: MK.log10_mel_spectrum(audio, m), torch, flush=flush),
            time_ms(lambda: A.log10_mel_spectrum(audio, m), torch, flush=flush),
            mel_bound(b, A.N_SAMPLES, m), None)
        if m == 80:
            t = device_times(key, lambda: MK.log10_mel_spectrum(audio), None, torch, checks,
                             host=True)
        if b == LARGE_V2_BATCH:
            entries["mel"], times = row, t
        del audio
    return times


def attention_backward_cases(torch, entries, checks, record, g, flush):
    """The differentiable encoder attention: the forward's LSE output and
    the backward kernels, bf16 at the finetune path's shapes (large-v2,
    batch 8) and fp32 at the agree phase's (base, batch 4)."""
    import torch.nn.functional as F

    from taiwan_whisper_tpu_torch.ops import attention as EA

    dev = flush.device
    T, D = 1500, 64
    src = "taiwan_whisper_tpu_torch/csrc/encoder_attention_bwd.cu"
    rep = "taiwan_whisper_tpu/ops/attention.py:158"

    # LSE of the scaled scores, natural log, ~log(1500) + O(1) ~ 8. The
    # kernel sums exact bf16 products in fp32 like the plain version (the
    # 1/8 scale is a power of two): tolerance 1e-4, ~100 fp32 ulps at 8.
    # The output of the LSE-writing launch must equal the plain launch's
    # bit for bit (same code, one more store).
    for dtype, (b, h) in ((torch.bfloat16, (FINETUNE_BATCH, 20)),
                          (torch.float32, (AGREE_BATCH, 8))):
        q, k, v = (torch.randn((b, T, h, D), generator=g, device=dev).to(dtype)
                   for _ in range(3))
        out, lse = EA.encoder_attention_lse(q, k, v)
        same = torch.equal(out, EA.encoder_attention(q, k, v))
        err = max_abs(lse, EA.lse_plain(q, k))
        log(f"[kernel] encoder_attention_lse[{str(dtype)[6:]}]: lse err {err:.3g} "
            f"(tol 1e-4), output equal to the no-LSE launch: {same}")
        if not (err <= 1e-4 and same):
            raise AssertionError(f"LSE output: err {err:.3g}, output equal {same}")
        if dtype == torch.bfloat16:
            device_times("encoder_attention_lse[bf16]", lambda: EA.encoder_attention_lse(q, k, v),
                         None, torch, checks)
    del q, k, v, out, lse

    def case(key, q, k, v, dout, tol, lib, dtype_kind, library_fn=None):
        """``tol`` None: two bf16 ulps at each gradient's largest |plain|,
        checked per gradient (the combined check takes the largest).
        ``library_fn``: also take device times, beside this function's."""
        b, s, h, d = q.shape
        out, lse = EA.encoder_attention_lse(q, k, v)
        got = EA.encoder_attention_backward(q, k, v, out, lse, dout)
        ref = EA.attention_backward_plain(q, k, v, dout)
        tols = []
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err, top = max_abs(a, r), float(r.float().abs().max())
            tols.append(tol if tol is not None else 2 * bf16_ulp(top))
            log(f"[kernel] {key} {name}: err {err:.3g} (tol {tols[-1]:.3g}), max |plain| "
                f"{top:.3g}")
            if not err <= tols[-1]:
                raise AssertionError(f"{key} {name}: max abs err {err:.3g} > {tols[-1]:.3g}")
        flops = 5 * 2 * b * h * s * s * d  # S, dV, dP, dK, dQ: 2*S*S*d each
        n_bytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
        if library_fn is not None:
            device_times(key, lambda: EA.encoder_attention_backward(q, k, v, out, lse, dout),
                         library_fn, torch, checks)
        return record(
            key, "encoder_attention_bwd", src, rep, torch.cat([x.flatten() for x in got]),
            torch.cat([x.flatten() for x in ref]), max(tols),
            time_ms(lambda: EA.encoder_attention_backward(q, k, v, out, lse, dout), torch,
                    flush=flush),
            time_ms(lambda: EA.attention_backward_plain(q, k, v, dout), torch, iters=3,
                    flush=flush),
            bound_ms(n_bytes, flops, dtype_kind), lib)

    # bf16 [8, 1500, 20, 64], unit-variance q/k/v/dO: scores of std 1, so P
    # is diffuse (~1/1500); the gradients reach ~1. Both sides round P (and
    # the kernel dS, the plain dP) to bf16 before the products and the
    # results to bf16 from fp32 sums taken in another order: tolerance two
    # bf16 ulps at each gradient's largest |plain| (7.8e-3 below 1). Then
    # peaked (q x 4, v / 4: a few keys carry each row, so a mis-weighted key
    # tile moves gradients by O(their size), which reach ~10) under the
    # same rule. The library yardstick is SDPA's backward through autograd
    # at the same shapes.
    bf = torch.bfloat16
    q, k, v, dout = (torch.randn((FINETUNE_BATCH, T, 20, D), generator=g, device=dev).to(bf)
                     for _ in range(4))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
    do_t = dout.transpose(1, 2)
    def sdpa_backward():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t, retain_graph=True)

    entries["encoder_attention_bwd"] = case("encoder_attention_bwd[bf16]", q, k, v, dout,
                                            None, time_ms(sdpa_backward, torch, flush=flush),
                                            "bf16", sdpa_backward)
    del qt, kt, vt, o_sdpa, do_t
    q4, v4 = (q.float() * 4).to(bf), (v.float() / 4).to(bf)
    case("encoder_attention_bwd[bf16,peaked]", q4, k, v4, dout, None, None, "bf16")
    del q, k, v, dout, q4, v4
    # fp32 [4, 1500, 8, 64] (the SIMT kernels of the agree phase's fp32
    # policy): fp32 throughout, only the summation order differs, gradients
    # < 1: tolerance 1e-5.
    q, k, v, dout = (torch.randn((AGREE_BATCH, T, 8, D), generator=g, device=dev)
                     for _ in range(4))
    case("encoder_attention_bwd[fp32,agree]", q, k, v, dout, 1e-5, None, "fp32")
    del q, k, v, dout
    # tensor parallel: a model rank's local heads at the finetune batch, 10
    # and 5 of 20 (bf16, the rule above, SDPA's backward beside), and the
    # fp32 kernels at 10 (the tensor_parallel phase's finetune; 1e-5)
    for h, dtype in ((10, bf), (5, bf), (10, torch.float32)):
        q, k, v, dout = (torch.randn((FINETUNE_BATCH, T, h, D), generator=g, device=dev)
                         .to(dtype) for _ in range(4))
        key = f"encoder_attention_bwd[{str(dtype)[6:]},B={FINETUNE_BATCH},H={h}]"
        if dtype == bf:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
            do_t = dout.transpose(1, 2)

            def sdpa_backward():
                return torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t, retain_graph=True)

            case(key, q, k, v, dout, None, time_ms(sdpa_backward, torch, flush=flush), "bf16",
                 sdpa_backward)
            del qt, kt, vt, o_sdpa, do_t
        else:
            case(key, q, k, v, dout, 1e-5, None, "fp32")
        del q, k, v, dout
    attention_edge_cases(torch, checks, g, dev)
    decoder_attention_edge_cases(torch, checks, g, dev)


def attention_edge_cases(torch, checks, g, dev):
    """The bf16 tensor maps and edge masks away from the main path's shapes,
    both directions, under the rules above (forward 8e-3 on unit inputs;
    LSE 1e-4 with the output equal bit for bit to the no-LSE launch; each
    gradient within two bf16 ulps of its largest |plain|): S = 300 (one
    partial tile of 44 rows in every kernel), B = 1 at S = 1500, and q/k/v
    as strided views of one [B, S, 3, H, 64] buffer (a stale map or a map
    built from the wrong strides reads the wrong rows). The launch counters
    are zeroed first and must count exactly these launches."""
    from taiwan_whisper_tpu_torch.ops import attention as EA

    bf = torch.bfloat16

    def separate(b, s, h):
        return tuple(torch.randn((b, s, h, 64), generator=g, device=dev).to(bf)
                     for _ in range(3))

    def packed(b, s, h):
        qkv = torch.randn((b, s, 3, h, 64), generator=g, device=dev).to(bf)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    cases = {"S=300": separate(2, 300, 4), "B=1,S=1500": separate(1, 1500, 20),
             "qkv-views": packed(2, 1500, 20)}
    zero_counters()
    for key, (q, k, v) in cases.items():
        out, lse = EA.encoder_attention_lse(q, k, v)
        same = torch.equal(out, EA.encoder_attention(q, k, v))
        errs = {"out": (max_abs(out, EA.attention_plain(q, k, v)), 8e-3),
                "lse": (max_abs(lse, EA.lse_plain(q, k)), 1e-4)}
        dout = torch.randn(q.shape, generator=g, device=dev).to(bf)
        got = EA.encoder_attention_backward(q, k, v, out, lse, dout)
        ref = EA.attention_backward_plain(q, k, v, dout)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            errs[name] = (max_abs(a, r), 2 * bf16_ulp(float(r.float().abs().max())))
        log(f"[kernel] encoder_attention edge {key} {tuple(q.shape)} strides {q.stride()}: "
            + ", ".join(f"{n} {e:.3g} (tol {t:.3g})" for n, (e, t) in errs.items())
            + f"; output equal to the no-LSE launch: {same}")
        checks.append(dict(check=f"encoder_attention_edge[{key}]", output_equal=same,
                           **{n: dict(max_abs_err=e, tolerance=t) for n, (e, t) in errs.items()}))
        bad = [n for n, (e, t) in errs.items() if not e <= t]
        if bad or not same:
            raise AssertionError(f"attention edge case {key}: {bad} out of tolerance, output "
                                 f"equal {same}")
    launches = read_counters()
    expected = dict({k: 0 for k in launches}, encoder_attention=2 * len(cases),
                    encoder_attention_bwd=len(cases))
    log(f"[kernel] encoder_attention edge launches {json.dumps(launches)} expected "
        f"{json.dumps(expected)}")
    if launches != expected:
        raise AssertionError(f"edge-case launch counts {launches} != expected {expected}")


def decoder_attention_edge_cases(torch, checks, g, dev):
    """The decoder attention kernel away from the distillation shapes, under
    the rules of its main cases (causal on v / 4 at 2e-2, cross on unit
    inputs at 8e-3): causal over S = 300 (a partial diagonal tile of 44
    rows) at B = 1 and over S = 1 (one query, one key), cross with one
    query row over 1500 keys, with Sq > Sk (200 queries, 77 keys: one
    ragged key tile), and cross on q, k and v that are strided views of
    [B, S, 3, H, 64] and [B, T, 2, H, 64] buffers. The launch counters are
    zeroed first and must count exactly these launches."""
    from taiwan_whisper_tpu_torch.ops import attention as EA

    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    qkv = rand(2, 448, 3, 8, 64)
    kv = rand(2, 1500, 2, 8, 64)
    cases = {"causal,B=1,S=300": (rand(1, 300, 2, 64), rand(1, 300, 2, 64),
                                  rand(1, 300, 2, 64, scale=0.25), True),
             "causal,S=1": (rand(2, 1, 4, 64), rand(2, 1, 4, 64),
                            rand(2, 1, 4, 64, scale=0.25), True),
             "cross,Sq=1": (rand(2, 1, 4, 64), rand(2, 1500, 4, 64), rand(2, 1500, 4, 64), False),
             "cross,Sq=200,Sk=77": (rand(3, 200, 4, 64), rand(3, 77, 4, 64), rand(3, 77, 4, 64),
                                    False),
             "cross,views": (qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1], False)}
    zero_counters()
    for key, (q, k, v, causal) in cases.items():
        s = q.shape[1]
        mask = (torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))[None, None]
                if causal else None)
        err, tol = max_abs(EA.decoder_attention(q, k, v, causal=causal),
                           EA.attention_plain(q, k, v, mask)), 2e-2 if causal else 8e-3
        log(f"[kernel] decoder_attention edge {key} q {tuple(q.shape)} k {tuple(k.shape)} "
            f"strides {q.stride()}: err {err:.3g} (tol {tol:g})")
        checks.append(dict(check=f"decoder_attention_edge[{key}]", max_abs_err=err,
                           tolerance=tol))
        if not err <= tol:
            raise AssertionError(f"decoder attention edge case {key}: err {err:.3g} > {tol:g}")
    launches = read_counters()
    expected = dict({k: 0 for k in launches}, decoder_attention=len(cases))
    log(f"[kernel] decoder_attention edge launches {json.dumps(launches)} expected "
        f"{json.dumps(expected)}")
    if launches != expected:
        raise AssertionError(f"decoder edge-case launch counts {launches} != expected {expected}")


def layer_norm_cases(torch, entries, checks, record, g, flush):
    """The LayerNorm kernel (not wired into the model, as in the JAX
    package) at the encoder's LN shape, [32 * 1500, 1280], bf16 and fp32,
    with fp32 scale and bias (the kernel rounds them to x's dtype); also
    timed back to back, per kernel and on the host, with a bitwise rerun,
    beside F.layer_norm given scale and bias already in x's dtype; returns
    those times by case."""
    import torch.nn.functional as F

    from taiwan_whisper_tpu_torch.ops import layer_norm as LN

    dev = flush.device
    n, d = LARGE_V2_BATCH * 1500, 1280
    times = {}
    # x ~ 3 N(0,1) + 1, scale 1 + 0.1 N(0,1), bias 0.1 N(0,1): outputs within
    # ~6. bf16 tolerance 3.2e-2, one bf16 ulp at [4, 8): both sides compute
    # the same fp32 value up to summation order and round it once.
    # fp32 tolerance 1e-5: only the summation order differs.
    for dtype, tol in ((torch.bfloat16, 3.2e-2), (torch.float32, 1e-5)):
        x = (torch.randn((n, d), generator=g, device=dev) * 3 + 1).to(dtype)
        scale = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        bias = 0.1 * torch.randn(d, generator=g, device=dev)
        sc, bi = scale.to(dtype), bias.to(dtype)
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        key = f"layer_norm[{kind}]"
        row = record(
            key, "layer_norm", "taiwan_whisper_tpu_torch/csrc/layer_norm.cu",
            "taiwan_whisper_tpu/ops/layer_norm.py:52",
            LN.layer_norm(x, scale, bias), LN.layer_norm_plain(x, scale, bias), tol,
            time_ms(lambda: LN.layer_norm(x, scale, bias), torch, iters=20, flush=flush),
            time_ms(lambda: LN.layer_norm_plain(x, scale, bias), torch, flush=flush),
            bound_ms(2 * x.numel() * x.element_size() + 2 * d * x.element_size(),
                     8 * x.numel(), kind),
            time_ms(lambda: F.layer_norm(x, (d,), sc, bi, 1e-5), torch, iters=20, flush=flush))
        times[key] = device_times(key, lambda: LN.layer_norm(x, scale, bias),
                                  lambda: F.layer_norm(x, (d,), sc, bi, 1e-5), torch, checks,
                                  host=True)
        if dtype == torch.bfloat16:
            entries["layer_norm"] = row
        del x
    return times


def layer_norm_edge_cases(torch, checks, g, dev):
    """The LayerNorm kernel away from the encoder's shape, under the same
    rules (3.2e-2 bf16, 1e-5 fp32, the inputs of layer_norm_cases): d = 384
    (the last 16-byte packs of a bf16 row on half the lanes) and d = 4096
    (the streamed route: two passes over the row), each with scale and bias
    in fp32 and in x's dtype. The launch counters are zeroed first and must
    count exactly these launches."""
    from taiwan_whisper_tpu_torch.ops import layer_norm as LN

    zero_counters()
    cases = 0
    for n, d in ((600, 384), (300, 4096)):
        for dtype, tol in ((torch.bfloat16, 3.2e-2), (torch.float32, 1e-5)):
            x = (torch.randn((n, d), generator=g, device=dev) * 3 + 1).to(dtype)
            scale = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
            bias = 0.1 * torch.randn(d, generator=g, device=dev)
            ref = LN.layer_norm_plain(x, scale, bias)
            for params in ("fp32", "x's dtype"):
                sc, bi = (scale, bias) if params == "fp32" else (scale.to(dtype), bias.to(dtype))
                err = max_abs(LN.layer_norm(x, sc, bi), ref)
                cases += 1
                key = f"layer_norm_edge[{str(dtype)[6:]},[{n},{d}],params {params}]"
                log(f"[kernel] {key}: err {err:.3g} (tol {tol:g})")
                checks.append(dict(check=key, max_abs_err=err, tolerance=tol))
                if not err <= tol:
                    raise AssertionError(f"{key}: err {err:.3g} > {tol:g}")
    launches = read_counters()
    expected = dict({k: 0 for k in launches}, layer_norm=cases)
    log(f"[kernel] layer_norm edge launches {json.dumps(launches)} expected "
        f"{json.dumps(expected)}")
    if launches != expected:
        raise AssertionError(f"layer norm edge-case launch counts {launches} != expected "
                             f"{expected}")


def _synth_wavs(out_dir: str, n: int, seconds: float, seed: int):
    from taiwan_whisper_tpu_torch.audio.io import write_wav

    rng = np.random.RandomState(seed)
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    paths = []
    for i in range(n):
        env = 0.6 + 0.4 * np.sin(2 * np.pi * (2 + i) * t)
        audio = (rng.randn(len(t)) * 0.2 * env).astype(np.float32)
        p = os.path.join(out_dir, f"utt{i}.wav")
        write_wav(p, audio)
        paths.append(os.path.basename(p))
    return paths


def write_large_v2(tmp: str, torch) -> str:
    """Random bf16 large-v2 weights from seed 0 as an HF checkpoint dir."""
    from taiwan_whisper_tpu_torch import get_config
    from taiwan_whisper_tpu_torch.models.io import save_hf_checkpoint
    from taiwan_whisper_tpu_torch.models.params import init_params, num_params

    t0 = time.perf_counter()
    cfg = get_config("large-v2")
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    model_dir = os.path.join(tmp, "large-v2")
    save_hf_checkpoint(model_dir, params, cfg)
    log(f"[setup] large-v2 bf16 checkpoint ({num_params(params) / 1e9:.3f} B params) "
        f"written in {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return model_dir


_students: dict = {}


def student_32_2(model_dir: str) -> str:
    """The 32-2 student ``cli init-student`` cuts from the random large-v2
    (2 maximally spaced decoder layers, the encoder whole), written beside
    it by the first phase that asks and read by every later one."""
    if model_dir not in _students:
        from taiwan_whisper_tpu_torch import cli

        out = os.path.join(os.path.dirname(model_dir), "student-32-2")
        t0 = time.perf_counter()
        cli.main(["init-student", "--teacher", model_dir, "--out", out, "--decoder_layers", "2"])
        log(f"[setup] cli init-student 32-2 in {time.perf_counter() - t0:.1f} s")
        _students[model_dir] = out
    return _students[model_dir]


def label_launches(cfg, batches: int, tokens: int = MAX_DECODE_TOKENS) -> dict:
    """Kernel launches of ``batches`` greedy batches (label's, the
    prefilter's): random weights never emit eot, so every batch runs the
    whole token budget."""
    return {"mel": batches, "encoder_attention": batches * cfg.encoder_layers,
            "encoder_attention_bwd": 0, "decoder_attention": 0,
            "cross_decode_attention": batches * cfg.decoder_layers * (1 + tokens),
            "self_decode_attention": batches * cfg.decoder_layers * tokens,
            "layer_norm": 0}


def phase_label(torch, entries: dict, results: dict, model_dir: str):
    """``cli label`` at b32 with fp8 cross-KV, then the same run with
    ``--quantize_kv 4`` (packed int4), on the same WAVs in one call: the
    audio-s/s of both side by side, each run's counters exact."""
    from taiwan_whisper_tpu_torch import cli, get_config
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest

    cfg = get_config("large-v2")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        names = _synth_wavs(audio_dir, LABEL_FILES, LABEL_SECONDS, seed=0)
        manifest = os.path.join(tmp, "manifest.tsv")
        write_manifest(manifest, Manifest(root=audio_dir, paths=names))
        for quant, path in (("fp8", "label"), ("4", "label_int4")):
            out_dir = os.path.join(tmp, path)
            zero_counters()
            t0 = time.perf_counter()
            stats = cli.main([
                "label", "--manifest", manifest, "--model", model_dir, "--output_dir", out_dir,
                "--batch_size", str(LARGE_V2_BATCH), "--quantize_kv", quant, "--language", "zh",
                "--vad_mode", "off", "--wire_mode", "chunks",
                "--max_decode_tokens", str(MAX_DECODE_TOKENS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counters()
            csvs = sorted(n for n in os.listdir(out_dir) if n.endswith(".csv"))
            rows = 0
            for n in csvs:
                with open(os.path.join(out_dir, n), encoding="utf-8") as f:
                    rows += sum(1 for _ in f) - 1
            batches = stats["batches"]
            expected = label_launches(cfg, batches)
            rate = stats["audio_seconds"] / stats["wall_seconds"]
            log(f"[{path}] --quantize_kv {quant}: {stats['files']} files, {stats['chunks']} "
                f"chunks, {batches} batches: {rate:.2f} audio-s/s (label_files wall "
                f"{stats['wall_seconds']:.2f} s, cli wall incl. checkpoint load {wall:.2f} s, "
                f"decode {stats['decode_s']:.2f} s); {len(csvs)} CSVs, {rows} segment rows")
            log(f"[{path}] launches {json.dumps(launches)} expected {json.dumps(expected)}")
            if stats["files"] != LABEL_FILES or len(csvs) != LABEL_FILES or batches != 2:
                raise AssertionError(f"{path} run incomplete: {stats}")
            if launches != expected:
                raise AssertionError(f"{path} launch counts {launches} != expected {expected}")
            add_launches(entries, results, path, launches)
            runs[quant] = dict(audio_s_per_s=rate, wall_seconds=stats["wall_seconds"],
                               cli_wall_seconds=wall, chunks=stats["chunks"], batches=batches,
                               decode_s=stats["decode_s"], csvs=len(csvs), segment_rows=rows)
    log(f"[label] audio-s/s in one call: fp8 {runs['fp8']['audio_s_per_s']:.2f}, int4 "
        f"{runs['4']['audio_s_per_s']:.2f}")
    results["label"] = dict(runs["fp8"], int4=runs["4"])


def vad_agree(torch, results: dict, audio_paths):
    """The device spectral scorer on the card against the same scorer on
    the CPU, on the label_vad corpus's int16 segments: energy within
    VAD_TOL["energy_db"] dB, flatness and modulation ratio within theirs,
    and equal regions per file. The modulation ratio is compared on blocks
    above the VAD's absolute floor (-65 dB) only: a block below it never
    passes the energy gate, and in digital silence the ratio divides
    rounding residues. Returns the seconds of the card's regions."""
    from taiwan_whisper_tpu_torch.audio.io import load_audio_16k
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.pipeline import vad

    resolve_device("cuda")  # fp32 matmuls in fp32, not TF32
    audios = [load_audio_16k(p) for p in audio_paths]
    segs = [vad._file_segments(a) for a in audios]
    flat = np.concatenate(segs)
    card = vad._score_segments(flat, "cuda")
    cpu = vad._score_segments(flat, "cpu")
    floor = vad.SpectralVadConfig.abs_floor_db
    err, regions_equal, pos = dict(energy_db=0.0, flatness=0.0, mod_ratio=0.0), True, 0
    kept = 0.0
    for audio, s in zip(audios, segs):
        total = len(audio) / 16000
        dc = vad._scores_dict(card[pos: pos + len(s)], total)
        dh = vad._scores_dict(cpu[pos: pos + len(s)], total)
        pos += len(s)
        loud = dh["energy_db"] > floor
        err["energy_db"] = max(err["energy_db"], float(np.abs(dc["energy_db"] - dh["energy_db"]).max()))
        err["flatness"] = max(err["flatness"], float(np.abs(dc["flatness"] - dh["flatness"]).max()))
        err["mod_ratio"] = max(err["mod_ratio"], float(
            np.abs(dc["mod_ratio"] - dh["mod_ratio"])[loud].max(initial=0.0)))
        regions = vad.spectral_speech_regions(audio, scores=dc)
        regions_equal &= regions == vad.spectral_speech_regions(audio, scores=dh)
        kept += sum(b - a for a, b in regions)
    # one scorer call: 8 segments in, scores back (CUDA events)
    call = torch.from_numpy(flat[: vad._VAD_CALL_SEGS]).cuda()
    scorer = vad._device_scorer("cuda")
    with torch.inference_mode():
        call_ms = time_ms(lambda: scorer(call), torch)
    log(f"[label_vad] card vs CPU scorer on {len(flat)} segments: max |diff| "
        + ", ".join(f"{k} {v:.3g} (tol {VAD_TOL[k]:g})" for k, v in err.items())
        + f"; regions equal: {regions_equal}; scorer {call_ms:.3f} ms per call of "
        f"{vad._VAD_CALL_SEGS} x 120 s segments on the card")
    results["vad_agree"] = dict(segments=len(flat), max_abs_diff=err, tolerance=VAD_TOL,
                                regions_equal=regions_equal, scorer_call_ms=call_ms)
    if not regions_equal or any(err[k] > VAD_TOL[k] for k in VAD_TOL):
        raise AssertionError(f"card-vs-CPU VAD scores {err} (tolerance {VAD_TOL}), regions "
                             f"equal {regions_equal}")
    return kept


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read_csvs(out_dir: str) -> dict:
    """The bytes of each CSV in ``out_dir``, by file name."""
    return {n: _read(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))
            if n.endswith(".csv")}


def phase_label_vad(torch, entries: dict, results: dict, model_dir: str):
    """``cli label`` with the shipped args file and no --vad_mode or
    --wire_mode: spectral VAD scored on the card, and the auto wire mode
    resolves to the device-resident driver. FLAC input of speech-like
    lectures. First the card-vs-CPU scorer check (which also warms the
    card's scorer), then three runs on the same corpus: the shipped one
    (one group buffer), the staged chunk route, and the resident route
    with ``--group_segs 3`` (groups of 3 x 120 s over ``LABEL_VAD_FILES``
    files of 170 s: a file spans two groups, so groups seal mid-file,
    batches read rows from a neighbour buffer, and buffers are freed while
    the upload thread fills the next). The three must write byte-equal CSVs, as
    the JAX package's tests hold its routes to; the two resident runs
    bracket the chunk run for the route rates."""
    from taiwan_whisper_tpu_torch import cli, get_config
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.tools.synth_audio import write_lecture_flacs

    t_phase = time.perf_counter()
    cfg = get_config("large-v2")
    args_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                             "label_large_v2.args")
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        names = write_lecture_flacs(audio_dir, LABEL_VAD_FILES, LABEL_SECONDS, seed=0)
        manifest = os.path.join(tmp, "manifest.tsv")
        write_manifest(manifest, Manifest(root=audio_dir, paths=names))
        kept = vad_agree(torch, results, [os.path.join(audio_dir, n) for n in names])
        total = LABEL_VAD_FILES * LABEL_SECONDS
        log(f"[label_vad] the VAD kept {kept:.1f} s of {total:.1f} s ({kept / total:.3f})")
        if not 0.0 < kept < total:
            raise AssertionError(f"the VAD kept {kept} s of {total} s")
        runs, csvs = {}, {}
        for route, extra in (("resident", []), ("chunks", ["--wire_mode", "chunks"]),
                             ("resident_group_segs_3", ["--group_segs", "3"])):
            out_dir = os.path.join(tmp, route)
            zero_counters()
            t0 = time.perf_counter()
            stats = cli.main([
                "label", f"@{args_file}", "--manifest", manifest, "--model", model_dir,
                "--output_dir", out_dir, "--max_decode_tokens", str(MAX_DECODE_TOKENS),
                *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counters()
            csvs[route] = _read_csvs(out_dir)
            expected = label_launches(cfg, stats["batches"])
            rate = stats["audio_seconds"] / stats["wall_seconds"]
            log(f"[label_vad] {route}: {stats['files']} files, {stats['chunks']} chunks, "
                f"{stats['batches']} batches, groups {stats.get('groups')}: {rate:.2f} "
                f"audio-s/s (label_files wall {stats['wall_seconds']:.2f} s, cli wall "
                f"{wall:.2f} s, decode {stats['decode_s']:.2f} s, vad {stats['vad_s']:.3f} s, "
                f"upload wait {stats.get('upload_wait_s', 0.0):.3f} s); "
                f"{len(csvs[route])} CSVs")
            log(f"[label_vad] {route} launches {json.dumps(launches)} expected "
                f"{json.dumps(expected)}")
            if (stats["files"] != LABEL_VAD_FILES or len(csvs[route]) != LABEL_VAD_FILES
                    or not stats["batches"]):
                raise AssertionError(f"label_vad {route} run incomplete: {stats}")
            if launches != expected:
                raise AssertionError(f"label_vad {route} launch counts {launches} != "
                                     f"expected {expected}")
            add_launches(entries, results, f"label_vad_{route}", launches)
            runs[route] = dict(audio_s_per_s=rate, wall_seconds=stats["wall_seconds"],
                               cli_wall_seconds=wall, chunks=stats["chunks"],
                               batches=stats["batches"], vad_s=stats["vad_s"],
                               decode_s=stats["decode_s"], groups=stats.get("groups"),
                               upload_wait_s=stats.get("upload_wait_s"))
        res, small = runs["resident"], runs["resident_group_segs_3"]
        if res["groups"] is None or res["groups"] < 1:
            raise AssertionError(f"the shipped args did not take the resident route: {res}")
        if small["groups"] is None or small["groups"] <= res["groups"]:
            raise AssertionError(f"--group_segs 3 did not cut more groups: {runs}")
        if len({r["chunks"] for r in runs.values()}) != 1:
            raise AssertionError(f"the runs cut different chunks: {runs}")
        differ = sorted(n for route in runs for n in csvs["resident"]
                        if csvs[route].get(n) != csvs["resident"][n])
        log(f"[label_vad] CSVs byte-equal across {', '.join(runs)}: {not differ}")
        if differ:
            raise AssertionError(f"label_vad CSVs differ between runs: {differ}")
    phase_s = time.perf_counter() - t_phase
    log(f"[label_vad] phase wall {phase_s:.1f} s")
    results["label_vad"] = dict(runs, vad_seconds_kept=kept, seconds_in=total,
                                phase_seconds=phase_s)


def phase_label_beam(torch, entries: dict, results: dict, model_dir: str):
    """``cli label @configs/label_large_v2_beam.args`` as shipped (large-v2,
    batch 8, 5 beams, int8 cross-KV, chunked; spectral VAD on the card and
    the resident route by default) on ``BEAM_FILES`` FLAC lectures of
    ``BEAM_SECONDS``, with ``--max_decode_tokens BEAM_TOKENS``. Random
    weights emit no eot, so no item is done before the budget: the launch
    counters must equal the greedy count at batch 8 (beams fold into the
    cross kernel's rows and are batch rows to the self kernel). Then one
    batch of chunks decoded directly at budgets of 8 and 8 + BEAM_TOKENS
    gives the ms per beam step (the difference over the extra steps), and a
    traced window of that loop (``BEAM_TRACE_WINDOW``) its device work by
    kernel, the cache reorder's (aten::index_select) and the top-k's
    (aten::topk) device ms and their shares of the step."""
    from taiwan_whisper_tpu_torch import DtypePolicy, cli, get_config
    from taiwan_whisper_tpu_torch.audio.io import load_audio_16k
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.decode.longform import decode_audio
    from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.models.params import prepare_params
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from taiwan_whisper_tpu_torch.tools.synth_audio import write_lecture_flacs

    t_phase = time.perf_counter()
    cfg = get_config("large-v2")
    args_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                             "label_large_v2_beam.args")
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        names = write_lecture_flacs(audio_dir, BEAM_FILES, BEAM_SECONDS, seed=1)
        manifest = os.path.join(tmp, "manifest.tsv")
        write_manifest(manifest, Manifest(root=audio_dir, paths=names))
        out_dir = os.path.join(tmp, "labels")
        zero_counters()
        t0 = time.perf_counter()
        stats = cli.main(["label", f"@{args_file}", "--manifest", manifest, "--model",
                          model_dir, "--output_dir", out_dir,
                          "--max_decode_tokens", str(BEAM_TOKENS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        csvs = _read_csvs(out_dir)
        rows = sum(c.count(b"\n") - 1 for c in csvs.values())
        audio = np.stack([load_audio_16k(os.path.join(audio_dir, n))[:30 * 16000]
                          for n in names] * (BEAM_BATCH // BEAM_FILES))
    batches = stats["batches"]
    expected = label_launches(cfg, batches, BEAM_TOKENS)
    rate = stats["audio_seconds"] / stats["wall_seconds"]
    log(f"[label_beam] {stats['files']} files, {stats['chunks']} chunks, {batches} batches of "
        f"{BEAM_BATCH} x {BEAMS} beams, groups {stats.get('groups')}: {rate:.2f} audio-s/s "
        f"(label_files wall {stats['wall_seconds']:.2f} s, cli wall {wall:.2f} s, decode "
        f"{stats['decode_s']:.2f} s, vad {stats['vad_s']:.3f} s); {len(csvs)} CSVs, "
        f"{rows} segment rows")
    log(f"[label_beam] launches {json.dumps(launches)} expected {json.dumps(expected)}")
    if stats["files"] != BEAM_FILES or len(csvs) != BEAM_FILES or not batches \
            or stats.get("groups") is None:
        raise AssertionError(f"label_beam run incomplete or not resident: {stats}")
    if launches != expected:
        raise AssertionError(f"label_beam launch counts {launches} != expected {expected}")
    add_launches(entries, results, "label_beam", launches)

    # the beam step: one batch of chunks at two budgets, then a traced window
    params, _ = load_model(model_dir)
    params = prepare_params(params, DtypePolicy(), "cuda")
    tok = WhisperTokenizer()
    rules = DecodeRules.from_special(tok.special)
    sot = tok.sot_sequence("zh")
    prefix = torch.tensor([sot] * BEAM_BATCH, dtype=torch.int32, device="cuda")
    wave = torch.from_numpy(audio).cuda()

    def run(budget):
        return decode_audio(params, wave, prefix, cfg, rules, DtypePolicy(),
                            max_len=len(sot) + budget, quantize_kv=8, num_beams=BEAMS,
                            device="cuda")

    run(8)  # warm-up
    walls = {}
    for budget in (8, 8 + BEAM_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(budget)
        torch.cuda.synchronize()
        walls[budget] = time.perf_counter() - t0
    step_ms = (walls[8 + BEAM_TOKENS] - walls[8]) / BEAM_TOKENS * 1e3
    [w] = trace_decode_steps(torch, lambda: run(BEAM_TOKENS), (BEAM_TRACE_WINDOW,),
                             name="beam")
    # the reorder's strided index_select runs a generic gather kernel: read
    # both parts from their aten ops
    shares = {k: w["op_ms_per_step"].get(op, 0.0)
              for k, op in (("reorder", "aten::index_select"), ("top_k", "aten::topk"))}
    log(f"[label_beam] beam step (batch {BEAM_BATCH} x {BEAMS}, untraced): {step_ms:.3f} ms "
        f"(budgets 8 and {8 + BEAM_TOKENS}: {walls[8]:.3f} s, {walls[8 + BEAM_TOKENS]:.3f} s); "
        f"traced positions {w['first']}-{w['first'] + w['steps'] - 1}: device busy "
        f"{w['busy_ms_per_step']:.3f} ms per step ({100 * w['busy_ms_per_step'] / step_ms:.1f}% "
        f"of the untraced step), {w['launch_calls_per_step']:.1f} launch calls per step; "
        f"reorder {shares['reorder']:.4f} ms ({100 * shares['reorder'] / step_ms:.2f}% of the "
        f"step), top-k {shares['top_k']:.4f} ms ({100 * shares['top_k'] / step_ms:.2f}%)")
    for k in w["kernels"][:14]:
        log(f"    {k['ms_per_step']:8.4f} ms/step {k['calls_per_step']:6.1f}/step  "
            f"{k['name'][:90]}")
    phase_s = time.perf_counter() - t_phase
    log(f"[label_beam] phase wall {phase_s:.1f} s")
    results["label_beam"] = dict(
        audio_s_per_s=rate, wall_seconds=stats["wall_seconds"], cli_wall_seconds=wall,
        chunks=stats["chunks"], batches=batches, groups=stats.get("groups"),
        decode_s=stats["decode_s"], csvs=len(csvs), segment_rows=rows, beam_step_ms=step_ms,
        trace_window=w, reorder_ms_per_step=shares["reorder"],
        top_k_ms_per_step=shares["top_k"], phase_seconds=phase_s)


def phase_longform(torch, entries: dict, results: dict, model_dir: str):
    """The long-form and evaluation paths on the 32-2 student that ``cli
    init-student`` cuts from the random large-v2 (full-width encoder, 2
    decoder layers), with a byte-level vocab: ``cli evaluate`` with
    ``configs/eval_short.args`` (greedy, then ``--num_beams 5``),
    ``eval_longform_sequential.args`` and ``eval_longform_chunked.args``
    (manifest, model and vocab overridden) on ``LONGFORM_UTTS`` speech-like
    utterances with zh/en references; ``cli transcribe`` of a
    ``LONGFORM_LECTURE_S`` lecture, sequential (srt; more than one window
    must run) and chunked (json; more than one chunk, so the stride merge
    runs); then ``sequential_decode(temperatures=(0.0,))`` on a
    ``LONGFORM_PROMPT_S`` lecture, greedy and beam 5, which prompts each
    window after the first with the text before it: a conditioned prefill
    of more than 8 rows must run (times 5 rows under beam). Each run's counters are zeroed before and read after;
    mel, encoder attention, cross and self must each have launched, and
    each output must be there."""
    from taiwan_whisper_tpu_torch import DtypePolicy, cli, get_config
    from taiwan_whisper_tpu_torch.audio.io import load_audio_16k, write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.decode.longform import chunk_with_stride, sequential_decode
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.models.params import prepare_params
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture, write_lecture_flacs

    t_phase = time.perf_counter()
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    path_kernels = ("mel", "encoder_attention", "cross_decode_attention",
                    "self_decode_attention")
    runs = {}

    def counted(name, fn):
        zero_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        log(f"[longform] {name}: {wall:.2f} s, launches {json.dumps(launches)}")
        missing = [k for k in path_kernels if not launches[k]]
        if missing:
            raise AssertionError(f"longform {name}: no launch of {missing}")
        add_launches(entries, results, f"longform_{name}", launches)
        runs[name] = dict(wall_s=wall, launches=launches)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        student = student_32_2(model_dir)
        tok_dir, test_dir, lec_dir = (os.path.join(tmp, k) for k in ("tok", "test", "lec"))
        for d in (tok_dir, test_dir, lec_dir):
            os.makedirs(d)
        _byte_vocab(tok_dir)
        rng = np.random.RandomState(4)
        refs = ["今天我們來討論語音辨識 hello world", "Whisper 模型的訓練資料 code-switching"]
        for i in range(LONGFORM_UTTS):
            write_flac(os.path.join(test_dir, f"u{i}.flac"), synth_lecture(rng, 8.0 + 3 * i))
            with open(os.path.join(test_dir, f"u{i}.txt"), "w", encoding="utf-8") as f:
                f.write(refs[i % len(refs)] + "\n")
        manifest = os.path.join(tmp, "test.tsv")
        write_manifest(manifest, Manifest(root=test_dir, paths=[
            f"u{i}.flac" for i in range(LONGFORM_UTTS)]))
        [lecture] = write_lecture_flacs(lec_dir, 1, LONGFORM_LECTURE_S, seed=5)
        audio = load_audio_16k(os.path.join(lec_dir, lecture))

        common = ["--manifest", manifest, "--model", student, "--tokenizer_dir", tok_dir]
        for name, argv in (
                ("evaluate_short", ["evaluate", f"@{configs}/eval_short.args"]),
                ("evaluate_short_beam5", ["evaluate", f"@{configs}/eval_short.args",
                                          "--num_beams", str(BEAMS)]),
                ("evaluate_sequential", ["evaluate",
                                         f"@{configs}/eval_longform_sequential.args"]),
                ("evaluate_chunked", ["evaluate", f"@{configs}/eval_longform_chunked.args"])):
            out_dir = os.path.join(tmp, name)
            metrics = counted(name, lambda: cli.main(argv + common + ["--output_dir", out_dir]))
            with open(os.path.join(out_dir, "eval_predictions.tsv"), encoding="utf-8") as f:
                lines = f.read().splitlines()
            log(f"[longform] {name}: {json.dumps(metrics)}")
            if metrics["n_samples"] != LONGFORM_UTTS or len(lines) != LONGFORM_UTTS + 1 \
                    or not np.isfinite(metrics["mer"]):
                raise AssertionError(f"{name}: {metrics}, {len(lines)} prediction lines")
            runs[name]["metrics"] = metrics
        for strategy, fmt in (("sequential", "srt"), ("chunked", "json")):
            out_dir = os.path.join(tmp, f"transcribe_{strategy}")
            segments = counted(f"transcribe_{strategy}", lambda: cli.main([
                "transcribe", "--audio", lec_dir, "--model", student, "--tokenizer_dir",
                tok_dir, "--output_dir", out_dir, "--strategy", strategy, "--format", fmt]))
            written = os.path.join(out_dir, lecture.replace(".flac", f".{fmt}"))
            # the windows sequential decoding encoded (one encode of one
            # window launches the attention once a layer), the chunks
            # chunked decoding cut (chunk_with_stride at its defaults)
            pieces = (runs[f"transcribe_{strategy}"]["launches"]["encoder_attention"]
                      // get_config("large-v2").encoder_layers if strategy == "sequential"
                      else len(chunk_with_stride(audio)))
            log(f"[longform] transcribe {strategy}: {segments}, {pieces} "
                f"{'windows' if strategy == 'sequential' else 'chunks'}, "
                f"{os.path.getsize(written)} bytes of {fmt}")
            if not os.path.getsize(written) or list(segments.values()) == [0] or pieces < 2:
                raise AssertionError(f"transcribe {strategy}: {segments}, {pieces} windows "
                                     f"or chunks")
            runs[f"transcribe_{strategy}"].update(segments=list(segments.values())[0],
                                                  pieces=pieces)

        params, scfg = load_model(student)
        params = prepare_params(params, DtypePolicy(), "cuda")
        audio = synth_lecture(np.random.RandomState(6), LONGFORM_PROMPT_S)
        tok = WhisperTokenizer.from_pretrained_dir(tok_dir)
        for beams in (1, BEAMS):
            stats = {}
            res = counted(f"sequential_beams{beams}", lambda: sequential_decode(
                params, audio, scfg, tok, temperatures=(0.0,), num_beams=beams,
                device="cuda", stats=stats))
            log(f"[longform] sequential_decode, beams {beams}: {len(res.segments)} segments, "
                f"{stats['windows']} windows, longest prefix {stats['max_prefix']} tokens "
                f"({stats['max_prefix'] * beams} cross query rows an item)")
            if stats["max_prefix"] <= 8 or not res.segments:
                raise AssertionError(f"sequential_decode beams {beams}: no conditioned "
                                     f"prefill of more than 8 rows ran: {stats}")
            runs[f"sequential_beams{beams}"].update(stats, segments=len(res.segments))
    phase_s = time.perf_counter() - t_phase
    log(f"[longform] phase wall {phase_s:.1f} s")
    results["longform"] = dict(runs, phase_seconds=phase_s)


def phase_speculative(torch, entries: dict, results: dict, model_dir: str):
    """Speculative decoding at large-v2 width: the 32-2 student that ``cli
    init-student`` cuts from the random large-v2 drafts (it shares the
    teacher's encoder), the teacher verifies with ``extend`` (the cross
    kernel at 6 rows, batch 1). ``cli evaluate
    @configs/eval_speculative.args`` (manifest, model, assistant and vocab
    overridden) on ``SPEC_UTTS`` utterances, each decoded to the teacher's
    448 positions (random weights emit no eot), then ``cli label
    @configs/label_large_v2.args --assistant`` with ``--max_decode_tokens
    SPEC_TOKENS`` on ``SPEC_FILES`` FLAC lectures of ``SPEC_SECONDS``
    (spectral VAD on the card, one window at a time). Rounds and accept
    rates are read from each ``speculative_decode`` call; each run's
    counters must show mel, encoder attention, self attention, and cross
    attention at 1 row (the student's steps) and 6 rows (extend)."""
    from taiwan_whisper_tpu_torch import cli
    from taiwan_whisper_tpu_torch.audio.io import write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.ops import decode_attention as DA
    from taiwan_whisper_tpu_torch.pipeline import evaluate as E
    from taiwan_whisper_tpu_torch.pipeline import label as L
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture, write_lecture_flacs

    t_phase = time.perf_counter()
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    runs, calls = {}, []

    def recorded(fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            calls.append(dict(rounds=res.rounds, accept=res.draft_accept_rate,
                              length=res.length, seconds=time.perf_counter() - t0))
            return res
        return call

    def counted(name, fn):
        zero_counters()
        calls.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        by_rows = dict(DA.cross_attention.launches_by_rows)
        rounds = sum(c["rounds"] for c in calls)
        accept = float(np.mean([c["accept"] for c in calls])) if calls else float("nan")
        log(f"[speculative] {name}: {wall:.2f} s, {len(calls)} speculative_decode calls, "
            f"{rounds} rounds, mean draft accept rate {accept:.4f}, tokens "
            f"{[c['length'] for c in calls]}, launches {json.dumps(launches)}, cross launches "
            f"by rows {json.dumps(by_rows)}")
        missing = [k for k in ("mel", "encoder_attention", "self_decode_attention")
                   if not launches[k]] + [f"cross at {r} rows" for r in (1, DRAFTS + 1)
                                          if not by_rows.get(r)]
        if missing or not calls:
            raise AssertionError(f"speculative {name}: no launch of {missing}, or no "
                                 f"speculative_decode call ({len(calls)})")
        add_launches(entries, results, f"speculative_{name}", launches)
        runs[name] = dict(wall_s=wall, launches=launches, cross_by_rows=by_rows,
                          decodes=len(calls), rounds=rounds, draft_accept_rate=accept,
                          ms_per_round=1e3 * sum(c["seconds"] for c in calls) / max(rounds, 1))
        return out

    saved = E.speculative_decode, L.speculative_decode
    E.speculative_decode, L.speculative_decode = (recorded(f) for f in saved)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            student = student_32_2(model_dir)
            tok_dir, test_dir, lec_dir = (os.path.join(tmp, k) for k in ("tok", "test", "lec"))
            for d in (tok_dir, test_dir, lec_dir):
                os.makedirs(d)
            _byte_vocab(tok_dir)
            rng = np.random.RandomState(8)
            for i in range(SPEC_UTTS):
                write_flac(os.path.join(test_dir, f"u{i}.flac"), synth_lecture(rng, 8.0 + 3 * i))
                with open(os.path.join(test_dir, f"u{i}.txt"), "w", encoding="utf-8") as f:
                    f.write("今天我們來討論語音辨識 hello world\n")
            manifest = os.path.join(tmp, "test.tsv")
            write_manifest(manifest, Manifest(root=test_dir, paths=[
                f"u{i}.flac" for i in range(SPEC_UTTS)]))
            out_dir = os.path.join(tmp, "eval")
            metrics = counted("evaluate", lambda: cli.main([
                "evaluate", f"@{configs}/eval_speculative.args", "--manifest", manifest,
                "--model", model_dir, "--assistant", student, "--tokenizer_dir", tok_dir,
                "--output_dir", out_dir]))
            log(f"[speculative] evaluate: {json.dumps(metrics)}")
            if metrics["n_samples"] != SPEC_UTTS or not np.isfinite(metrics["rtf"]):
                raise AssertionError(f"speculative evaluate: {metrics}")
            runs["evaluate"].update(rtf=metrics["rtf"],
                                    audio_s_per_s=metrics["audio_seconds_per_second"])

            names = write_lecture_flacs(lec_dir, SPEC_FILES, SPEC_SECONDS, seed=9)
            lec_manifest = os.path.join(tmp, "lectures.tsv")
            write_manifest(lec_manifest, Manifest(root=lec_dir, paths=names))
            label_dir = os.path.join(tmp, "labels")
            stats = counted("label", lambda: cli.main([
                "label", f"@{configs}/label_large_v2.args", "--manifest", lec_manifest,
                "--model", model_dir, "--assistant", student, "--output_dir", label_dir,
                "--max_decode_tokens", str(SPEC_TOKENS)]))
            csvs = _read_csvs(label_dir)
            rate = stats["audio_seconds"] / stats["wall_seconds"]
            log(f"[speculative] label: {stats['files']} files, {stats['spec_windows']} windows, "
                f"{stats['spec_rounds']} rounds, draft accept rate "
                f"{stats['draft_accept_rate']:.4f}, {rate:.2f} audio-s/s (RTF "
                f"{1 / rate:.3f}), {len(csvs)} CSVs")
            if stats["files"] != SPEC_FILES or len(csvs) != SPEC_FILES \
                    or stats["spec_windows"] != len(calls):
                raise AssertionError(f"speculative label run incomplete: {stats}")
            runs["label"].update(audio_s_per_s=rate, rtf=1 / rate,
                                 windows=stats["spec_windows"])
    finally:
        E.speculative_decode, L.speculative_decode = saved
    phase_s = time.perf_counter() - t_phase
    log(f"[speculative] phase wall {phase_s:.1f} s")
    results["speculative"] = dict(runs, phase_seconds=phase_s)


PREFILTER_WORDS = ["今天", "我們", "來", "討論", "語音", "辨識", "模型", "的", "訓練", "資料",
                   "hello", "world", "Whisper", "GPU", "code-switching", "，", "。"]


def _pseudo_label_csvs(trans_dir: str, names, seconds: float):
    """A label CSV per lecture: utterances of 2-12 s with gaps of 0-1 s
    and zh/en text, seeded per file."""
    import csv

    for i, name in enumerate(names):
        rng = np.random.RandomState(100 + i)
        t, rows = float(rng.uniform(0, 2)), []
        while True:
            end = t + float(rng.uniform(2, 12))
            if end > seconds:
                break
            rows.append((f"{t:.3f}", f"{end:.3f}",
                         "".join(rng.choice(PREFILTER_WORDS, rng.randint(2, 12)))))
            t = end + float(rng.uniform(0, 1))
        with open(os.path.join(trans_dir, os.path.splitext(name)[0] + ".csv"), "w",
                  newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["start", "end", "text"])
            w.writerows(rows)


def write_base(tmp: str, torch) -> str:
    """Random bf16 whisper-base weights from seed 0 as an HF checkpoint dir:
    the validator of configs/prefilter_base_0.4.args at full width."""
    from taiwan_whisper_tpu_torch import get_config
    from taiwan_whisper_tpu_torch.models.io import save_hf_checkpoint
    from taiwan_whisper_tpu_torch.models.params import init_params

    model_dir = os.path.join(tmp, "whisper-base")
    save_hf_checkpoint(model_dir, init_params(get_config("base"), seed=0, device="cuda",
                                              dtype=torch.bfloat16), get_config("base"))
    return model_dir


def phase_prefilter(torch, entries: dict, results: dict):
    """Stage 2 on the port's CLI: ``cli segment`` of 8 FLAC lectures with
    seeded pseudo-label CSVs into 72 segments, ``cli make-manifest
    --valid_percent 0.1`` over them, then ``cli prefilter
    @configs/prefilter_base_0.4.args`` (batch 64, threshold 0.4, zh) with a
    random full-width whisper-base validator on the segment manifest: two
    batches (the second with 56 zero-audio pad rows), each running the
    448-token budget (random weights never emit eot), launch counters zeroed
    just before and checked just after. Then ``filter_manifest`` on the CPU
    from the card's ``idx_hyp.0.txt`` must write the card run's
    ``hallucination_result.csv`` and cleaned TSV byte for byte, and keep
    every segment at a threshold above every MER. The first batch is then
    decoded again with ``PREFILTER_TRACE_WINDOWS`` traced
    (``trace_decode_steps``). Last, the validator at the fp32 policy on 4
    segments over the whole budget, card against CPU, must agree on at
    least 0.98 of the token positions."""
    from taiwan_whisper_tpu_torch import DtypePolicy, cli, get_config
    from taiwan_whisper_tpu_torch.audio.manifest import read_manifest
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.pipeline import prefilter as PF
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from taiwan_whisper_tpu_torch.tools.synth_audio import write_lecture_flacs

    t_phase = time.perf_counter()
    # what earlier phases leave in the process, which the host-bound loop shares
    process = dict(threads=threading.active_count(), gc_objects=len(gc.get_objects()))
    log(f"[prefilter] process at the phase's start: {process['threads']} Python threads, "
        f"{process['gc_objects']} GC-tracked objects")
    cfg = get_config("base")
    args_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                             "prefilter_base_0.4.args")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("audio", "trans", "segments", "manifests",
                                                  "tok", "card", "cpu", "cpu_keep_all")}
        for k in ("audio", "trans", "tok"):
            os.makedirs(dirs[k])
        model_dir = write_base(tmp, torch)
        _byte_vocab(dirs["tok"])
        names = write_lecture_flacs(dirs["audio"], PREFILTER_LECTURES, PREFILTER_SECONDS, seed=0)
        _pseudo_label_csvs(dirs["trans"], names, PREFILTER_SECONDS)
        cli.main(["segment", "--trans_dir", dirs["trans"], "--audio_dir", dirs["audio"],
                  "--output_dir", dirs["segments"]])
        seg_manifest = os.path.join(dirs["segments"], "train.tsv")
        segs = read_manifest(seg_manifest)
        cli.main(["make-manifest", "--root", dirs["segments"], "--out", dirs["manifests"],
                  "--valid_percent", "0.1"])
        split = {k: read_manifest(os.path.join(dirs["manifests"], f"{k}.tsv")).paths
                 for k in ("train", "valid")}
        n = len(segs)
        # segment audio seconds from the names: <stem>_<start>-<end>.flac
        audio_s = sum(int(e) - int(s) for s, e in (
            re.search(r"_(\d+)-(\d+)\.flac$", p).groups() for p in segs.paths)) / 16000
        log(f"[prefilter] cli segment: {n} segments ({audio_s:.1f} s) from "
            f"{PREFILTER_LECTURES} lectures; make-manifest: train {len(split['train'])}, "
            f"valid {len(split['valid'])}")
        if n < PREFILTER_MIN_SEGMENTS or not split["valid"] or \
                sorted(split["train"] + split["valid"]) != sorted(segs.paths):
            raise AssertionError(f"segment / make-manifest: {n} segments, split {split}")

        zero_counters()
        t0 = time.perf_counter()
        stats = cli.main(["prefilter", f"@{args_file}", "--manifest", seg_manifest,
                          "--validator", model_dir, "--output_dir", dirs["card"],
                          "--tokenizer_dir", dirs["tok"]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        batches = -(-n // PREFILTER_BATCH)
        steps = PREFILTER_BUDGET - 3
        expected = label_launches(cfg, batches, steps)
        step_ms = stats["decode_s"] / (stats["batches"] * stats["steps"]) * 1e3
        batch_step_ms = [t / stats["steps"] * 1e3 for t in stats["batch_decode_s"]]
        dropped = stats["hallucinated"] / max(stats["decisions"], 1)
        log(f"[prefilter] cli prefilter: {n} segments, {stats['batches']} batches of "
            f"{PREFILTER_BATCH} ({stats['pad_rows']} pad rows), {stats['steps']} steps: "
            f"{n / stats['wall_s']:.3f} segments/s, {audio_s / stats['wall_s']:.2f} audio-s/s "
            f"(validator wall {stats['wall_s']:.2f} s, decode {stats['decode_s']:.2f} s = "
            f"{' + '.join(f'{t:.2f}' for t in stats['batch_decode_s'])} by batch, load "
            f"wait {stats['load_wait_s']:.3f} s, filter {stats['filter_s']:.3f} s, cli wall "
            f"incl. checkpoint load {wall:.2f} s); {step_ms:.3f} ms per step ("
            f"{' + '.join(f'{t:.3f}' for t in batch_step_ms)} by batch); dropped "
            f"{stats['hallucinated']} of {stats['decisions']} ({dropped:.3f})")
        log(f"[prefilter] launches {json.dumps(launches)} expected {json.dumps(expected)}")
        if stats["batches"] != batches or stats["steps"] != steps:
            raise AssertionError(f"prefilter run: {stats}")
        if launches != expected:
            raise AssertionError(f"prefilter launch counts {launches} != expected {expected}")
        add_launches(entries, results, "prefilter", launches)

        # the filter again on the CPU from the card's hyps
        hyps = PF.read_hyps_tsv([os.path.join(dirs["card"], "idx_hyp.0.txt")])
        _, decisions = PF.filter_manifest(segs, hyps, PF.PrefilterConfig(threshold=0.4),
                                          dirs["cpu"])
        differ = [f for f in ("hallucination_result.csv",
                              "train_non-hallucinated-threshold0.4.tsv")
                  if _read(os.path.join(dirs["card"], f)) != _read(os.path.join(dirs["cpu"], f))]
        top = max(d.mer for d in decisions if d.mer is not None)
        keep_all, _ = PF.filter_manifest(segs, hyps, PF.PrefilterConfig(threshold=top + 1.0),
                                         dirs["cpu_keep_all"])
        log(f"[prefilter] CPU re-filter of the card's hyps ({len(hyps)} of {n}): files "
            f"byte-equal: {not differ}; at threshold {top + 1.0:.4f} (above every MER) kept "
            f"{len(keep_all)} of {len(decisions)}")
        if differ or len(hyps) != n or len(keep_all) != len(decisions):
            raise AssertionError(f"CPU re-filter: files differ {differ}, {len(hyps)} hyps of "
                                 f"{n}, kept {len(keep_all)} of {len(decisions)} at "
                                 f"threshold {top + 1.0}")

        # where a step's time goes: the validator on the CLI's checkpoint,
        # tokenizer and first batch, two windows of its loop traced
        params, vcfg = load_model(model_dir)
        tok = WhisperTokenizer.from_pretrained_dir(dirs["tok"])
        windows = trace_decode_steps(torch, lambda: PF.validator_decode(
            params, vcfg, tok, segs.absolute_paths()[:PREFILTER_BATCH],
            PF.PrefilterConfig(batch_size=PREFILTER_BATCH, max_decode_len=PREFILTER_BUDGET),
            device="cuda"), PREFILTER_TRACE_WINDOWS)
        for w in windows:
            log(f"[prefilter] traced positions {w['first']}-{w['first'] + w['steps'] - 1}: "
                f"{w['traced_ms_per_step']:.3f} ms per step under the profiler, device busy "
                f"{w['busy_ms_per_step']:.3f} ms per step ("
                f"{100 * w['busy_ms_per_step'] / batch_step_ms[-1]:.1f}% of the CLI's last "
                f"batch's step), {w['launch_calls_per_step']:.1f} launch calls per step")
            for k in w["kernels"][:12]:
                log(f"    {k['ms_per_step']:8.4f} ms/step {k['calls_per_step']:6.1f}/step  "
                    f"{k['name'][:90]}")

        # card vs CPU at the fp32 policy, PREFILTER_AGREE segments, the whole budget
        agree_cfg = PF.PrefilterConfig(batch_size=PREFILTER_AGREE,
                                       max_decode_len=PREFILTER_BUDGET)
        paths = segs.absolute_paths()[:PREFILTER_AGREE]
        rows = {dev: np.stack([r for _, r, _ in PF.validator_decode(
            params, vcfg, tok, paths, agree_cfg, DtypePolicy.fp32(), device=dev)])
            for dev in ("cuda", "cpu")}
        agreement = float((rows["cuda"] == rows["cpu"]).mean())
        log(f"[prefilter] validator card vs CPU at fp32 ({PREFILTER_AGREE} segments, "
            f"{PREFILTER_BUDGET - 3} tokens): token agreement {agreement:.4f}")
        if agreement < 0.98:
            raise AssertionError(f"validator card-vs-CPU token agreement {agreement:.4f} < 0.98")
    phase_s = time.perf_counter() - t_phase
    log(f"[prefilter] phase wall {phase_s:.1f} s")
    results["prefilter"] = dict(
        segments=n, segment_audio_s=audio_s, batches=stats["batches"],
        pad_rows=stats["pad_rows"], steps=stats["steps"],
        segments_per_s=n / stats["wall_s"], audio_s_per_s=audio_s / stats["wall_s"],
        validator_wall_s=stats["wall_s"], decode_s=stats["decode_s"],
        batch_decode_s=stats["batch_decode_s"], step_ms=step_ms,
        filter_s=stats["filter_s"], cli_wall_s=wall, dropped=stats["hallucinated"],
        dropped_share=dropped, refilter_equal=not differ, agreement=agreement,
        batch_step_ms=batch_step_ms, trace_windows=windows, process=process,
        phase_seconds=phase_s)


def trace_decode_steps(torch, run, windows, name: str = "prefilter") -> list:
    """``run()`` with torch.profiler on over each (first position, steps)
    window of the greedy loop it drives: ``models.whisper.decode_step`` is
    wrapped for the call, so that the profiler starts (after a sync) as the
    step at ``first`` is issued and stops (after a sync) as the step at
    ``first + steps`` is, and a window holds that many whole loop
    iterations: the decode step, then the rules and argmax of the next
    token. Each window is traced once; the traces are read after ``run()``
    returns. Returns, per window, the device ms per step by kernel, its sum
    (busy), the traced wall per step and the host's kernel-launch calls per
    step, and the device ms per step under each aten op; writes each trace
    under chiprun_out/ as ``<name>_steps_<first>.json``.
    Beam search calls ``decode_step`` too: its window holds the step, then
    the rules, top-k and cache reorder of the next."""
    from taiwan_whisper_tpu_torch.models import whisper as M

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    orig, live, done = M.decode_step, {}, {}

    def step(params, cross_kv, cache, token, index, *args, **kw):
        for first, n in windows:
            if index == first + n and first in live:
                torch.cuda.synchronize()
                prof, t0 = live.pop(first)
                done[first] = (prof, (time.perf_counter() - t0) * 1e3)
                prof.stop()
            if index == first and first not in live and first not in done:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                live[first] = (prof, time.perf_counter())
        return orig(params, cross_kv, cache, token, index, *args, **kw)

    with torch.profiler.profile(activities=acts):  # warm-up: the first start sets up CUPTI
        torch.cuda.synchronize()
    M.decode_step = step
    try:
        run()
    finally:
        M.decode_step = orig
    if live or len(done) != len(windows):
        raise AssertionError(f"traced windows {sorted(done)} of {windows}")
    os.makedirs("chiprun_out", exist_ok=True)
    out = []
    for first, n in windows:
        prof, wall = done[first]
        avg = prof.key_averages()
        kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                          for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0), reverse=True)
        launch_calls = sum(e.count for e in avg if e.device_type == torch.autograd.DeviceType.CPU
                           and e.key.startswith(("cudaLaunch", "cuLaunch")))
        # device time under each aten op (its kernels), for ops no kernel name tells apart
        op_ms = {e.key: e.device_time_total / 1e3 / n for e in avg
                 if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")
                 and e.device_time_total > 0}
        prof.export_chrome_trace(os.path.join("chiprun_out", f"{name}_steps_{first}.json"))
        out.append(dict(first=first, steps=n, traced_ms_per_step=wall / n,
                        busy_ms_per_step=sum(k[0] for k in kernels),
                        launch_calls_per_step=launch_calls / n, op_ms_per_step=op_ms,
                        kernels=[dict(name=k[:100], ms_per_step=ms, calls_per_step=c)
                                 for ms, c, k in kernels]))
    return out


def _segment_corpus(root: str, copies: int):
    """One synthetic 30 s WAV segment and its 2-line transcript (zh/en text
    with no timestamps and no prompt, so no random draw changes its labels)
    listed ``copies`` times, plus a byte-level vocab: every batch is the
    same batch. Returns (manifest path, tokenizer dir)."""
    from taiwan_whisper_tpu_torch.audio.io import write_wav
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest

    seg_dir, tok_dir = os.path.join(root, "segments"), os.path.join(root, "tok")
    os.makedirs(seg_dir)
    os.makedirs(tok_dir)
    rng = np.random.RandomState(3)
    t = np.arange(30 * 16000) / 16000
    write_wav(os.path.join(seg_dir, "seg.wav"),
              (rng.randn(len(t)) * 0.2 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
               ).astype(np.float32))
    with open(os.path.join(seg_dir, "seg.txt"), "w", encoding="utf-8") as f:
        f.write("今天我們來測試語音模型 hello world, this is a code-switching test "
                "中英混合的句子<|endoftext|>\n\n")
    manifest = os.path.join(root, "train.tsv")
    write_manifest(manifest, Manifest(root=seg_dir, paths=["seg.wav"] * copies))
    _byte_vocab(tok_dir)
    return manifest, tok_dir


def _byte_vocab(tok_dir: str):
    """A byte-level vocab (ids 0-255, no merges) in ``tok_dir``: text
    tokens decode to real bytes."""
    from taiwan_whisper_tpu_torch.text.tokenizer import bytes_to_unicode

    with open(os.path.join(tok_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({ch: i for i, ch in enumerate(bytes_to_unicode().values())}, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def _train_run(torch, entries, results, name, argv, out_dir, steps, batch, expected):
    """One ``cli distill``/``cli finetune`` run with its launch counters
    zeroed just before and read just after; step rate from the per-step
    log lines (each waits for its step), peak device memory."""
    from taiwan_whisper_tpu_torch import cli

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = cli.main(argv + ["--output_dir", out_dir, "--max_steps", str(steps),
                               "--batch_size", str(batch), "--logging_steps", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "metrics.jsonl"), encoding="utf-8") as f:
        logged = [json.loads(line) for line in f if '"train/loss"' in line]
    exported = os.path.exists(os.path.join(out_dir, "hf_export", "model.safetensors"))
    shutil.rmtree(out_dir)
    losses = [r["train/loss"] for r in logged]
    times = [r["time"] for r in logged]
    # the first step builds cuBLAS plans and the like: rate over the rest
    steps_per_s = (len(times) - 1) / (times[-1] - times[0])
    res = dict(batch=batch, steps=steps, losses=losses, steps_per_s=steps_per_s,
               samples_per_s=steps_per_s * batch, peak_bytes=peak, cli_wall_s=wall,
               final=metrics)
    log(f"[train] {name}: batch {batch}, {steps} steps, losses "
        f"{[round(x, 4) for x in losses]}, {steps_per_s:.3f} steps/s = "
        f"{steps_per_s * batch:.2f} samples/s (steps 2-{steps}), peak "
        f"{peak / 1e9:.2f} GB, cli wall {wall:.1f} s")
    log(f"[train] {name} launches {json.dumps(launches)} expected {json.dumps(expected)}")
    if len(losses) != steps or not all(np.isfinite(losses)) or not exported:
        raise AssertionError(f"{name}: incomplete run: {losses}, hf_export {exported}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall on a repeated batch: {losses}")
    if launches != expected:
        raise AssertionError(f"{name}: launch counts {launches} != expected {expected}")
    add_launches(entries, results, name, launches)
    results.setdefault("train", {})[name] = res
    return res


def phase_train(torch, entries: dict, results: dict, model_dir: str):
    from taiwan_whisper_tpu_torch import cli, get_config

    cfg = get_config("large-v2")
    none = {k: 0 for k in kernel_counters()}
    with tempfile.TemporaryDirectory() as tmp:
        manifest, tok_dir = _segment_corpus(tmp, 2 * LARGE_V2_BATCH)
        student_dir = student_32_2(model_dir)
        # configs/distill_32_2.args semantics; one warmup step (lr 0), then
        # the shipped lr, so the loss of a repeated batch must fall
        distill = ["distill", "--manifest", manifest, "--teacher", model_dir,
                   "--student", student_dir, "--learning_rate", "1e-4",
                   "--warmup_steps", "1", "--lr_schedule", "constant_with_warmup",
                   "--ce_weight", "0.8", "--kl_weight", "1.0", "--temperature", "2.0",
                   "--language", "zh", "--tokenizer_dir", tok_dir]

        def distill_expected(steps):
            # the teacher's causal and cross attention, each layer and step
            return dict(none, mel=steps, encoder_attention=cfg.encoder_layers * steps,
                        decoder_attention=2 * cfg.decoder_layers * steps)

        res = _train_run(torch, entries, results, "distill", distill,
                         os.path.join(tmp, "distill"), DISTILL_STEPS, LARGE_V2_BATCH,
                         distill_expected(DISTILL_STEPS))
        # the shipped batch of 64, if twice the batch-32 peak fits the card
        if 2 * res["peak_bytes"] <= CARD_BYTES:
            _train_run(torch, entries, results, "distill_b64", distill,
                       os.path.join(tmp, "distill64"), 3, 2 * LARGE_V2_BATCH,
                       distill_expected(3))
        else:
            log(f"[train] distill at batch 64 not run: twice the batch-32 peak, "
                f"{2 * res['peak_bytes'] / 1e9:.1f} GB, exceeds {CARD_BYTES / 1e9:.0f} GB")
            results["train"]["distill_b64"] = "not run: would not fit"
        # finetune with the encoder trainable: each checkpointed encoder
        # layer runs its forward twice and its backward once per step
        finetune = ["finetune", "--manifest", manifest, "--model", student_dir,
                    "--warmup_steps", "1", "--language", "zh", "--tokenizer_dir", tok_dir]
        _train_run(torch, entries, results, "finetune", finetune,
                   os.path.join(tmp, "finetune"), FINETUNE_STEPS, FINETUNE_BATCH,
                   dict(none, mel=FINETUNE_STEPS,
                        encoder_attention=2 * cfg.encoder_layers * FINETUNE_STEPS,
                        encoder_attention_bwd=cfg.encoder_layers * FINETUNE_STEPS))


# the distributed phase (within 120 s): cli label --distributed as 2 ranks
# sharing the card on 2 FLAC lectures of 60 s (64 tokens), cli prefilter
# --distributed as 2 ranks on the segments of 1 lecture of 260 s, and cli
# distill --distributed at world size 1 (NCCL), 3 steps at batch 8 with a
# generation eval over one batch
DIST_RANKS, DIST_FILES, DIST_SECONDS, DIST_TOKENS = 2, 2, 60.0, 64
DIST_LECTURES, DIST_STEPS, DIST_BATCH = 1, 3, 8
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """What ``torchrun`` sets for one rank; every rank on card 0."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                MASTER_ADDR="localhost", MASTER_PORT=str(port))


def rank_main(argv) -> int:
    """One rank of a multi-process run (``chip_smoke.py _rank <cli args>``):
    the port's ``cli.main(argv)`` with the launch counters zeroed just
    before; prints ``RANK_RESULT {"launches": ..., "result": ...}``."""
    import torch

    from taiwan_whisper_tpu_torch import cli

    zero_counters()
    result = cli.main(argv)
    torch.cuda.synchronize()
    print("RANK_RESULT " + json.dumps({"launches": read_counters(), "result": result}),
          flush=True)
    return 0


def start_ranks(argv, world: int, entry: str = "_rank") -> list:
    """``argv`` as ``world`` ranks of one run, each a process of its own on
    card 0 (``chip_smoke.py <entry> <argv>``), started together;
    ``finish_ranks`` waits for them."""
    port = _free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), entry, *argv],
                             env=dict(os.environ, **rank_env(r, world, port)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def stop_ranks(procs: list):
    """Kill every rank still running and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_ranks(procs: list, name: str) -> list:
    """Each rank's (launches, result). A rank that fails or outlives
    ``RANK_TIMEOUT_S`` fails the phase (every rank is stopped first); each
    rank's output goes to chiprun_out/."""
    world = len(procs)
    os.makedirs("chiprun_out", exist_ok=True)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        stop_ranks(procs)
    for r, out in enumerate(outs):
        with open(os.path.join("chiprun_out", f"{name}_rank{r}.log"), "w",
                  encoding="utf-8") as f:
            f.write(out)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or len(outs) != world:
        raise AssertionError(f"{name}: ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}:\n{outs[r][-3000:] if r < len(outs) else '(no output)'}"
            for r in failed))
    res = []
    for r, out in enumerate(outs):
        [line] = [x for x in out.splitlines() if x.startswith("RANK_RESULT ")]
        got = json.loads(line[len("RANK_RESULT "):])
        res.append((got["launches"], got["result"]))
    return res


def phase_distributed(torch, entries: dict, results: dict, model_dir: str):
    """Multi-process runs of the port's CLI. (a) ``cli label
    @configs/label_large_v2.args --distributed`` as ``DIST_RANKS`` processes
    sharing the card (label never reduces a device tensor, so no NCCL
    communicator is built) on ``DIST_FILES`` FLAC lectures: each rank labels
    its 2 files, its counters equal its batches' count, and the CSVs equal a
    one-process run's byte for byte. (b) ``cli prefilter
    @configs/prefilter_base_0.4.args --distributed`` as 2 ranks on the
    segments of ``DIST_LECTURES`` lectures: disjoint, non-empty
    ``idx_hyp.<rank>.txt`` shards, and rank 0's merged
    ``hallucination_result.csv`` and cleaned TSV equal a one-process run's.
    (c) ``cli distill --distributed`` at world size 1 (the NCCL all-reduces
    of the data-parallel step on the card), ``DIST_STEPS`` steps at batch
    ``DIST_BATCH`` with ``--eval_manifest`` and ``--gen_eval_batches 1``,
    against the same run without ``--distributed``: losses and the
    ``hf_export`` tensors bitwise equal, ``metrics.jsonl`` holding
    ``eval/gen_mer`` and both prediction tables, both step rates logged."""
    from taiwan_whisper_tpu_torch import cli, get_config
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, read_manifest, write_manifest
    from taiwan_whisper_tpu_torch.models.io import read_safetensors
    from taiwan_whisper_tpu_torch.tools.synth_audio import write_lecture_flacs

    t_phase = time.perf_counter()
    cfg, base = get_config("large-v2"), get_config("base")
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) label, 2 ranks sharing the card, against one process
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        names = write_lecture_flacs(audio_dir, DIST_FILES, DIST_SECONDS, seed=2)
        manifest = os.path.join(tmp, "lectures.tsv")
        write_manifest(manifest, Manifest(root=audio_dir, paths=names))
        label = ["label", f"@{os.path.join(configs, 'label_large_v2.args')}", "--manifest",
                 manifest, "--model", model_dir, "--max_decode_tokens", str(DIST_TOKENS)]
        # the one-process run beside the ranks, on the same card
        t0 = time.perf_counter()
        procs = start_ranks(label + ["--output_dir", os.path.join(tmp, "label_dp"),
                                     "--distributed"], DIST_RANKS)
        try:
            zero_counters()
            stats = cli.main(label + ["--output_dir", os.path.join(tmp, "label_sp")])
            torch.cuda.synchronize()
            one = read_counters()
        except BaseException:
            stop_ranks(procs)
            raise
        sp_wall = time.perf_counter() - t0
        ranks = finish_ranks(procs, "distributed_label")
        dp_wall = time.perf_counter() - t0
        for r, (launches, st) in enumerate(ranks):
            want = label_launches(cfg, st["batches"], DIST_TOKENS)
            log(f"[distributed] label rank {r}: {st['files']} files, {st['chunks']} chunks, "
                f"{st['batches']} batches, {st['audio_seconds'] / st['wall_seconds']:.2f} "
                f"audio-s/s; launches {json.dumps(launches)}")
            if st["files"] != DIST_FILES // DIST_RANKS or launches != want:
                raise AssertionError(f"label rank {r}: {st}, launches {launches} != {want}")
            add_launches(entries, results, f"distributed_label_rank{r}", launches)
        if one != label_launches(cfg, stats["batches"], DIST_TOKENS) or stats["files"] != DIST_FILES:
            raise AssertionError(f"one-process label: {stats}, launches {one}")
        csv_dp, csv_sp = _read_csvs(os.path.join(tmp, "label_dp")), \
            _read_csvs(os.path.join(tmp, "label_sp"))
        log(f"[distributed] label, sharing the card: {DIST_RANKS} ranks {dp_wall:.1f} s of "
            f"command (start-up and checkpoint load included), one process {sp_wall:.1f} s "
            f"({stats['audio_seconds'] / stats['wall_seconds']:.2f} audio-s/s); {len(csv_dp)} "
            f"CSVs, byte-equal to one process: {csv_dp == csv_sp}")
        if len(csv_sp) != DIST_FILES or csv_dp != csv_sp:
            raise AssertionError("distributed label CSVs differ from the one-process run's")
        out["label"] = dict(ranks_wall_s=dp_wall, one_process_wall_s=sp_wall,
                            rank_stats=[st for _, st in ranks], csvs=len(csv_dp))

        # (b) prefilter, 2 ranks sharing the card, against one process
        dirs = {k: os.path.join(tmp, k) for k in ("pf_audio", "trans", "segments", "tok")}
        for k in ("pf_audio", "trans", "tok"):
            os.makedirs(dirs[k])
        base_dir = write_base(tmp, torch)
        _byte_vocab(dirs["tok"])
        lectures = write_lecture_flacs(dirs["pf_audio"], DIST_LECTURES, PREFILTER_SECONDS,
                                       seed=3)
        _pseudo_label_csvs(dirs["trans"], lectures, PREFILTER_SECONDS)
        cli.main(["segment", "--trans_dir", dirs["trans"], "--audio_dir", dirs["pf_audio"],
                  "--output_dir", dirs["segments"]])
        segs = os.path.join(dirs["segments"], "train.tsv")
        n_segs = len(read_manifest(segs))
        prefilter = ["prefilter", f"@{os.path.join(configs, 'prefilter_base_0.4.args')}",
                     "--manifest", segs, "--validator", base_dir, "--tokenizer_dir", dirs["tok"]]
        pf_dp, pf_sp = os.path.join(tmp, "pf_dp"), os.path.join(tmp, "pf_sp")
        t0 = time.perf_counter()
        procs = start_ranks(prefilter + ["--output_dir", pf_dp, "--distributed"], DIST_RANKS)
        try:
            zero_counters()
            stats = cli.main(prefilter + ["--output_dir", pf_sp])
            torch.cuda.synchronize()
            one = read_counters()
        except BaseException:
            stop_ranks(procs)
            raise
        ranks = finish_ranks(procs, "distributed_prefilter")
        dp_wall = time.perf_counter() - t0
        steps = PREFILTER_BUDGET - 3
        shards = []
        for r, (launches, st) in enumerate(ranks):
            with open(os.path.join(pf_dp, f"idx_hyp.{r}.txt"), encoding="utf-8") as f:
                shards.append({int(x.split("\t")[0]) for x in f if "\t" in x})
            log(f"[distributed] prefilter rank {r}: {st['segments']} segments, "
                f"{st['batches']} batches, decode {st['decode_s']:.2f} s; launches "
                f"{json.dumps(launches)}")
            if launches != label_launches(base, st["batches"], steps):
                raise AssertionError(f"prefilter rank {r}: launches {launches}")
            add_launches(entries, results, f"distributed_prefilter_rank{r}", launches)
        if one != label_launches(base, stats["batches"], steps):
            raise AssertionError(f"one-process prefilter launches {one}")
        same = {n: _read(os.path.join(pf_dp, n)) == _read(os.path.join(pf_sp, n))
                for n in ("hallucination_result.csv",
                          "train_non-hallucinated-threshold0.4.tsv")}
        log(f"[distributed] prefilter: {n_segs} segments, shards of {[len(x) for x in shards]}, "
            f"{DIST_RANKS} ranks {dp_wall:.1f} s of command beside one process; rank 0's merged "
            f"files byte-equal "
            f"to one process: {same}")
        if not all(shards) or shards[0] & shards[1] or \
                shards[0] | shards[1] != set(range(n_segs)):
            raise AssertionError(f"prefilter shards not disjoint or incomplete: {shards}")
        if not all(same.values()):
            raise AssertionError(f"distributed prefilter files differ: {same}")
        out["prefilter"] = dict(segments=n_segs, shards=[len(x) for x in shards],
                                ranks_wall_s=dp_wall)

        # (c) distill at world size 1 through NCCL, against the plain run
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        train, tok_dir = _segment_corpus(corpus, 4 * DIST_BATCH)
        evals = os.path.join(corpus, "eval.tsv")
        write_manifest(evals, Manifest(root=os.path.join(corpus, "segments"),
                                       paths=["seg.wav"] * DIST_BATCH))
        student, student_layers = student_32_2(model_dir), 2
        distill = ["distill", "--manifest", train, "--teacher", model_dir, "--student",
                   student, "--warmup_steps", "1", "--language", "zh", "--tokenizer_dir",
                   tok_dir, "--max_steps", str(DIST_STEPS), "--batch_size", str(DIST_BATCH),
                   "--logging_steps", "1", "--eval_steps", str(DIST_STEPS),
                   "--eval_manifest", evals, "--gen_eval_batches", "1"]
        runs = {}
        for run, extra in (("plain", []), ("distributed", ["--distributed"])):
            run_dir = os.path.join(tmp, f"distill_{run}")
            saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                     "MASTER_ADDR", "MASTER_PORT")}
            if extra:
                os.environ.update(rank_env(0, 1, _free_port()))
            zero_counters()
            t0 = time.perf_counter()
            try:
                cli.main(distill + ["--output_dir", run_dir] + extra)
                torch.cuda.synchronize()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            wall = time.perf_counter() - t0
            launches = read_counters()
            with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
                records = [json.loads(line) for line in f]
            train_recs = [r for r in records if "train/loss" in r]
            times = [r["time"] for r in train_recs]
            runs[run] = dict(
                losses=[r["train/loss"] for r in train_recs],
                steps_per_s=(len(times) - 1) / (times[-1] - times[0]), cli_wall_s=wall,
                gen_mer=[r["eval/gen_mer"] for r in records if "eval/gen_mer" in r],
                tables=[r["table"] for r in records if "table" in r], launches=launches,
                export=read_safetensors(os.path.join(run_dir, "hf_export",
                                                     "model.safetensors")))
            shutil.rmtree(run_dir)
            log(f"[distributed] distill {run}: losses {runs[run]['losses']}, "
                f"{runs[run]['steps_per_s']:.3f} steps/s (steps 2-{DIST_STEPS}), gen_mer "
                f"{runs[run]['gen_mer']}, tables {runs[run]['tables']}, cli wall {wall:.1f} s; "
                f"launches {json.dumps(launches)}")
            # mel and encoder: each train step, the eval batch and the
            # generation eval's batch; the decoder's cross and self kernels
            # in the generation eval (prefill: cross only; a trained
            # student may stop early, at a multiple of 8 steps); the
            # decoder attention kernel: the teacher's 2 a layer each train
            # step, and teacher's and student's in the loss-only eval batch
            n = DIST_STEPS + 2
            dec = 2 * cfg.decoder_layers * DIST_STEPS + 2 * (cfg.decoder_layers + student_layers)
            if (launches["mel"] != n or launches["encoder_attention"] != n * cfg.encoder_layers
                    or launches["decoder_attention"] != dec
                    or launches["self_decode_attention"] <= 0
                    or launches["cross_decode_attention"]
                    != launches["self_decode_attention"] + student_layers):
                raise AssertionError(f"distill {run}: launch counts {launches}")
            if len(runs[run]["losses"]) != DIST_STEPS or len(runs[run]["gen_mer"]) != 1 or \
                    runs[run]["tables"] != ["eval/predictions", "eval/incorrect_predictions"]:
                raise AssertionError(f"distill {run}: metrics.jsonl incomplete")
            add_launches(entries, results, f"distributed_distill_{run}", launches)
        a, b = runs["plain"], runs["distributed"]
        differ = sorted(k for k in a["export"] if not torch.equal(a["export"][k],
                                                                  b["export"][k]))
        log(f"[distributed] distill --distributed (world 1, NCCL) against plain: losses "
            f"bitwise equal {a['losses'] == b['losses']}, gen_mer equal "
            f"{a['gen_mer'] == b['gen_mer']}, hf_export tensors differing {len(differ)} of "
            f"{len(a['export'])}; steps/s {b['steps_per_s']:.3f} against "
            f"{a['steps_per_s']:.3f}")
        if a["losses"] != b["losses"] or differ or a["launches"] != b["launches"]:
            raise AssertionError(f"distill --distributed differs from the plain run: losses "
                                 f"{a['losses']} vs {b['losses']}, tensors {differ[:5]}")
        out["distill"] = {k: {kk: v for kk, v in r.items() if kk != "export"}
                          for k, r in runs.items()}
    phase_s = time.perf_counter() - t_phase
    log(f"[distributed] phase wall {phase_s:.1f} s")
    results["distributed"] = dict(out, phase_seconds=phase_s)




def tp_jobs(torch, spec: dict, model_parallel: int, jobs) -> dict:
    """The tensor_parallel phase's ``jobs`` through the port's API on cuda:0
    at the fp32 policy, ``model_parallel`` ranks to a model group (1: this
    process alone): "distill", ``run_distillation`` of the 32-2 student
    from the large-v2 teacher (``TP_STEPS`` steps at batch ``TP_BATCH``,
    an eval batch and ``gen_eval_batches`` 1); "finetune",
    ``run_finetuning`` of the student (encoder trainable,
    ``TP_FINETUNE_STEPS`` steps); "decode", greedy (fp8 cross K/V) and
    beam-5 decoding of ``TP_UTTS`` utterances with the teacher,
    ``TP_TOKENS`` tokens. Per job: its launch counters (zeroed just before,
    read just after), wall, peak device memory and result."""
    from taiwan_whisper_tpu_torch import DtypePolicy
    from taiwan_whisper_tpu_torch.decode.beam import beam_decode
    from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
    from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.models.params import prepare_params
    from taiwan_whisper_tpu_torch.ops import mel_kernel
    from taiwan_whisper_tpu_torch.parallel import mesh, specs
    from taiwan_whisper_tpu_torch.pipeline.dataset import TrainPrepConfig
    from taiwan_whisper_tpu_torch.pipeline.distill_driver import (DistillRunConfig,
                                                                  run_distillation,
                                                                  run_finetuning)
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from taiwan_whisper_tpu_torch.train.state import OptimConfig

    fp32, dev = DtypePolicy.fp32(), "cuda:0"
    out = os.path.join(spec["out"], f"m{model_parallel}")
    common = dict(prep_cfg=TrainPrepConfig(language="zh"), tokenizer_dir=spec["tok"],
                  policy=fp32, device=dev)
    res = {}

    def job(name, fn):
        if name not in jobs:
            return
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        res[name] = dict(launches=read_counters(), wall_s=time.perf_counter() - t0,
                         peak_bytes=torch.cuda.max_memory_allocated(), **got)

    job("finetune", lambda: dict(final=run_finetuning(
        spec["train"], spec["student"], os.path.join(out, "finetune"), freeze_encoder=False,
        run_cfg=DistillRunConfig(max_steps=TP_FINETUNE_STEPS, batch_size=TP_BATCH,
                                 model_parallel=model_parallel, logging_steps=1,
                                 mix_lang_embeddings=False),
        opt_cfg=OptimConfig(learning_rate=1e-4, warmup_steps=1, total_steps=TP_FINETUNE_STEPS),
        **common)))
    job("distill", lambda: dict(final=run_distillation(
        spec["train"], spec["teacher"], os.path.join(out, "distill"),
        student_dir=spec["student"],
        run_cfg=DistillRunConfig(max_steps=TP_STEPS, batch_size=TP_BATCH,
                                 model_parallel=model_parallel, logging_steps=1,
                                 eval_steps=TP_STEPS, save_steps=TP_STEPS, gen_eval_batches=1),
        opt_cfg=OptimConfig(learning_rate=1e-4, warmup_steps=1, total_steps=TP_STEPS),
        eval_manifest_path=spec["eval"], **common)))

    def decode():
        params, cfg = load_model(spec["teacher"])
        if model_parallel > 1:
            mesh.make_mesh(model_parallel)
            params = specs.shard_params(params, mesh.model_rank(), model_parallel, cfg)
        params = prepare_params(params, fp32, dev)
        tok = WhisperTokenizer()
        rules = DecodeRules.from_special(tok.special, timestamps=True)
        sot = tok.sot_sequence("zh", "transcribe", timestamps=True)
        prefix = torch.tensor([sot] * TP_UTTS, dtype=torch.int32)
        audio = torch.from_numpy(np.load(spec["audio"])).to(dev)
        with torch.inference_mode():
            enc = M.encode(params, mel_kernel.log_mel(audio, cfg.num_mel_bins), cfg, fp32)
        greedy = greedy_decode(params, enc, prefix, cfg, rules, fp32,
                               max_len=len(sot) + TP_TOKENS, quantize_cross_kv="fp8",
                               device=dev)
        beam = beam_decode(params, enc, prefix, cfg, rules, fp32, num_beams=BEAMS,
                           max_len=len(sot) + TP_TOKENS, device=dev)
        return dict(greedy=greedy.tokens[:, len(sot):].tolist(),
                    beam=beam.all_tokens[:, :, len(sot):].tolist())

    job("decode", decode)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_rank_main(argv) -> int:
    """One rank of the tensor_parallel phase (``chip_smoke.py _tp_rank SPEC
    JOB...``): joins the run over gloo itself (NCCL refuses two ranks on one
    card), then runs ``tp_jobs`` at ``--model_parallel`` ``TP_RANKS``;
    prints ``RANK_RESULT {"launches": ..., "result": ...}``."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        res = tp_jobs(torch, json.loads(argv[0]), TP_RANKS, argv[1:])
    finally:
        dist.destroy_process_group()
    print("RANK_RESULT " + json.dumps({"launches": {k: r.pop("launches") for k, r in res.items()},
                                       "result": res}), flush=True)
    return 0


def phase_tensor_parallel(torch, entries: dict, results: dict, model_dir: str):
    """Tensor parallel at full large-v2 width: ``tp_jobs`` as sets of
    ``TP_RANKS`` ranks sharing the card at ``--model_parallel``
    ``TP_RANKS``, one set a group of jobs (``TP_RANK_SETS``; each rank
    joins over gloo, which stages the card's tensors through the host:
    correctness, not a speed; the weights split Megatron-style, so every
    attention kernel runs on 10 of the 20 heads), the sets at once and
    beside the same jobs in this process. Held: distill's and finetune's logged losses within 1e-4
    relative and their ``hf_export`` tensors within 1e-4 (the CPU test's
    tolerance) of the one-process run's; the greedy tokens and all beam
    hypotheses' tokens of each rank agree on at least 0.98 of positions
    with the one-process decode. Each rank's counters must show the kernels
    of each job: mel and encoder attention in all, the backward in
    finetune, cross and self in distill (its generation eval) and
    decode."""
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.audio.mel import N_SAMPLES
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_speech

    t_phase = time.perf_counter()
    resolve_device("cuda")  # TF32 off for the fp32 policy
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        train, tok_dir = _segment_corpus(corpus, 4 * TP_BATCH)
        evals = os.path.join(corpus, "eval.tsv")
        write_manifest(evals, Manifest(root=os.path.join(corpus, "segments"),
                                       paths=["seg.wav"] * TP_BATCH))
        student = student_32_2(model_dir)
        rng = np.random.RandomState(5)
        audio = np.zeros((TP_UTTS, N_SAMPLES), np.float32)
        for i in range(TP_UTTS):
            speech = synth_speech(rng, 8.0 + 6.0 * i)
            audio[i, :len(speech)] = speech
        np.save(os.path.join(tmp, "audio.npy"), audio)
        spec = dict(train=train, eval=evals, tok=tok_dir, teacher=model_dir, student=student,
                    audio=os.path.join(tmp, "audio.npy"), out=os.path.join(tmp, "runs"))
        t0 = time.perf_counter()
        sets = [start_ranks([json.dumps(spec), *jobs], TP_RANKS, entry="_tp_rank")
                for jobs in TP_RANK_SETS]
        try:
            one = tp_jobs(torch, spec, 1, ("finetune", "distill", "decode"))
        except BaseException:
            for procs in sets:
                stop_ranks(procs)
            raise
        one_wall = time.perf_counter() - t0
        # each rank's (launches, results) over every set
        ranks = [({}, {}) for _ in range(TP_RANKS)]
        for i, procs in enumerate(sets):
            for r, (launches, res) in enumerate(finish_ranks(procs, f"tensor_parallel_{i}")):
                ranks[r][0].update(launches)
                ranks[r][1].update(res)
        wall = time.perf_counter() - t0
        log(f"[tensor_parallel] set-up {t0 - t_phase:.1f} s; from the ranks' start: this "
            f"process's jobs done at {one_wall:.1f} s, every rank at {wall:.1f} s")

        def losses(m, name):
            with open(os.path.join(spec["out"], f"m{m}", name, "metrics.jsonl"),
                      encoding="utf-8") as f:
                return [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]

        out = dict(ranks_and_one_process_wall_s=wall)
        for name, steps in (("distill", TP_STEPS), ("finetune", TP_FINETUNE_STEPS)):
            a, b = losses(1, name), losses(TP_RANKS, name)
            rel = max(abs(x - y) / abs(x) for x, y in zip(a, b)) if len(a) == len(b) else None
            shapes, err = exports_max_abs(
                *(os.path.join(spec["out"], f"m{m}", name, "hf_export", "model.safetensors")
                  for m in (1, TP_RANKS)))
            log(f"[tensor_parallel] {name}: losses one process {a}, {TP_RANKS} ranks {b}: max "
                f"rel diff {rel} (tol 1e-4); hf_export tensors of full shapes "
                f"{shapes}, max abs diff {err} (tol 1e-4); walls one process "
                f"{one[name]['wall_s']:.1f} s, ranks "
                f"{[round(r[name]['wall_s'], 1) for _, r in ranks]} s; peak device memory "
                f"one process {one[name]['peak_bytes'] / 1e9:.2f} GB, ranks "
                f"{[round(r[name]['peak_bytes'] / 1e9, 2) for _, r in ranks]} GB")
            if len(a) != steps or len(b) != steps or not (rel <= 1e-4) or not shapes \
                    or not err <= 1e-4:
                raise AssertionError(f"tensor_parallel {name} differs from one process")
            out[name] = dict(losses_one=a, losses_ranks=b, loss_rel_diff=rel,
                             export_max_abs_diff=err, wall_one_s=one[name]["wall_s"],
                             wall_ranks_s=[r[name]["wall_s"] for _, r in ranks],
                             peak_one_bytes=one[name]["peak_bytes"],
                             peak_ranks_bytes=[r[name]["peak_bytes"] for _, r in ranks])
        agreements = {}
        for r, (_, res) in enumerate(ranks):
            for mode in ("greedy", "beam"):
                agreements[f"rank{r} {mode}"] = first_mismatch(
                    np.asarray(res["decode"][mode]), np.asarray(one["decode"][mode]))
        log(f"[tensor_parallel] decode of {TP_UTTS} utterances, {TP_TOKENS} tokens, split over "
            f"{TP_RANKS} ranks against one process (greedy with fp8 cross K/V, beam "
            f"{BEAMS}: all hypotheses): {agreements}; walls one process "
            f"{one['decode']['wall_s']:.1f} s, ranks "
            f"{[round(r['decode']['wall_s'], 1) for _, r in ranks]} s")
        if any(a < 0.98 for a, _ in agreements.values()):
            raise AssertionError(f"tensor_parallel decode agreement below 0.98: {agreements}")
        out["decode"] = {k: dict(agreement=a, first_mismatch=f)
                         for k, (a, f) in agreements.items()}
        want = {"distill": ("mel", "encoder_attention", "cross_decode_attention",
                            "self_decode_attention"),
                "finetune": ("mel", "encoder_attention", "encoder_attention_bwd"),
                "decode": ("mel", "encoder_attention", "cross_decode_attention",
                           "self_decode_attention")}
        for r, (launches, _) in enumerate(ranks):
            for name, counts in launches.items():
                log(f"[tensor_parallel] rank {r} {name} launches {json.dumps(counts)}")
                if not all(counts[k] > 0 for k in want[name]):
                    raise AssertionError(f"tensor_parallel rank {r} {name}: a kernel of the "
                                         f"path was not launched: {counts}")
                add_launches(entries, results, f"tensor_parallel_rank{r}_{name}", counts)
        for name, r in one.items():
            add_launches(entries, results, f"tensor_parallel_one_process_{name}", r["launches"])
    phase_s = time.perf_counter() - t_phase
    log(f"[tensor_parallel] phase wall {phase_s:.1f} s")
    results["tensor_parallel"] = dict(out, phase_seconds=phase_s)


def _pair_vocab(tok_dir: str):
    """A vocab in which every text id decodes: ids 0-255 the bytes, then
    byte pairs up to <|endoftext|> (random weights sample ids over the
    whole vocabulary, which a byte vocab would drop from the text)."""
    from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(chars)}
    vocab.update({chars[i // 256] + chars[i % 256]: i for i in range(256, MULTILINGUAL.eot)})
    with open(os.path.join(tok_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def _packed_corpus(tmp: str, rng):
    """Synthetic lectures named as video IDs, written as WAV, converted to
    FLAC by ``batch_convert``, measured by ``duration_stats`` and laid out by
    ``categorize_corpus`` (``move=False``: two EECS courses, one Law course,
    one video with no course); each FLAC cut into utterances of 4-12 s, the
    speaker changing with probability 0.4 among 2 or 3 a lecture. Returns
    (utterances, corpus facts)."""
    from taiwan_whisper_tpu_torch.audio import corpus, ingest
    from taiwan_whisper_tpu_torch.audio.io import load_audio_16k, write_wav
    from taiwan_whisper_tpu_torch.pipeline.packing import Utterance
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture

    raw, flac = os.path.join(tmp, "raw"), os.path.join(tmp, "flac")
    os.makedirs(raw)
    vids = [f"vid{i:04d}" for i in range(PACK_LECTURES)]
    n = int(PACK_SECONDS * 16000)
    for v in vids:
        write_wav(os.path.join(raw, v + ".wav"), synth_lecture(rng, PACK_SECONDS)[:n])
    t0 = time.perf_counter()
    converted = ingest.batch_convert([os.path.join(raw, v + ".wav") for v in vids], flac,
                                     num_workers=4)
    convert_s = time.perf_counter() - t0
    dsts = [d for _, d in converted]
    stats = ingest.duration_stats(dsts)
    vid_to_sid = {vids[0]: "901_001", vids[1]: "901_002", vids[2]: "A01_003"}
    layout = corpus.categorize_corpus(dsts, os.path.join(tmp, "bucketed"), vid_to_sid,
                                      move=False)
    log(f"[packed] batch_convert: {len(dsts)} WAV -> FLAC in {convert_s:.2f} s; "
        f"duration_stats: {stats.n_files} files, {stats.total_seconds:.1f} s (min "
        f"{stats.min_seconds:.1f}, max {stats.max_seconds:.1f}); categorize_corpus: "
        f"{layout.categories}, unknown {layout.unknown_vids}")
    if None in dsts or stats.n_files != PACK_LECTURES or \
            abs(stats.total_seconds - PACK_LECTURES * PACK_SECONDS) > 0.05 or \
            layout.categories != {"900": 2, "A00": 1, "unknown": 1} or \
            layout.unknown_vids != [vids[3]] or any(os.path.exists(d) for d in
                                                    layout.moved.values()):
        raise AssertionError(f"ingest / corpus: {converted} {stats} {layout}")
    utts = []
    for i, (v, path) in enumerate(zip(vids, dsts)):
        audio, s, spk, k = load_audio_16k(path), 0, 0, 0
        while s < len(audio):
            m = int(rng.uniform(4.0, 12.0) * 16000)
            if rng.rand() < 0.4:
                spk = int(rng.randint(2 + i % 2))
            utts.append(Utterance(audio[s:s + m], f"{v} utterance {k}", f"{v}_spk{spk}"))
            s, k = s + m, k + 1
    facts = dict(convert_s=convert_s, total_seconds=stats.total_seconds,
                 categories=layout.categories, utterances=len(utts))
    return utts, facts


def _read_rows(path: str):
    import csv

    with open(path, encoding="utf-8", newline="") as f:
        return list(csv.reader(f))


def phase_packed(torch, entries: dict, results: dict, model_dir: str):
    """The speaker-packing labeller on the card: ingest and corpus layout
    (``_packed_corpus``), ``pack_utterances``, then ``label_packed`` with the
    random large-v2 at batch 16 over ``PACK_PACKS`` packs (2 batches, the
    second with 8 zero-audio pad rows), the default bf16 policy (bf16 cross
    K/V) and timestamps, a CSV flush after every batch, each batch decoding
    the model's whole 448-position budget (random weights never emit eot):
    launch counters zeroed just before and checked just after, the CSV's
    rows and columns checked. Then the base preset at the fp32 policy (TF32
    off) on 4 packs over the whole budget, card against CPU: ``id``,
    ``condition_on_prev`` and ``text`` equal, ``whisper_transcript`` agreeing
    on at least 0.98 of its characters (1 - CER). Last ``utils/profiling``:
    ``device_time`` of ``encode`` at batch 16 inside ``trace(dir)``, whose
    trace file must parse (its kernel events are logged, not held: the
    profiler is known to drop some)."""
    from taiwan_whisper_tpu_torch import DtypePolicy, get_config
    from taiwan_whisper_tpu_torch.audio.mel import N_SAMPLES, pad_or_trim
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.models.params import init_params, prepare_params
    from taiwan_whisper_tpu_torch.ops.mel_kernel import log_mel
    from taiwan_whisper_tpu_torch.pipeline import packing as PK
    from taiwan_whisper_tpu_torch.text.metrics import edit_distance
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
    from taiwan_whisper_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    rng = np.random.RandomState(11)
    with tempfile.TemporaryDirectory() as tmp:
        utts, facts = _packed_corpus(tmp, rng)
        packs = PK.pack_utterances(utts)
        flags = [p.condition_on_prev for p in packs]
        log(f"[packed] pack_utterances: {len(utts)} utterances -> {len(packs)} packs "
            f"({sum(flags)} length splits flagged 1), the first {PACK_PACKS} labelled")
        if len(packs) < PACK_PACKS or not 0 < sum(flags[:PACK_PACKS]) < PACK_PACKS:
            raise AssertionError(f"pack_utterances: {len(packs)} packs, flags {flags}")
        packs = packs[:PACK_PACKS]
        audio_s = sum(len(p.audio) for p in packs) / 16000
        tok_dir = os.path.join(tmp, "tok")
        os.makedirs(tok_dir)
        _pair_vocab(tok_dir)
        tok = WhisperTokenizer.from_pretrained_dir(tok_dir)
        params, cfg = load_model(model_dir)
        policy = DtypePolicy()
        params = prepare_params(params, policy, "cuda")
        if cfg.max_target_positions != PACK_BUDGET:
            raise AssertionError(f"large-v2 has {cfg.max_target_positions} positions")

        batch_s = []
        decode = PK.decode_audio

        def timed_decode(*a, **k):
            t = time.perf_counter()
            res = decode(*a, **k)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t)
            return res

        csv_path = os.path.join(tmp, "card", "packed.csv")
        PK.decode_audio = timed_decode
        try:
            zero_counters()
            t0 = time.perf_counter()
            texts = PK.label_packed(params, cfg, tok, packs, csv_path, policy, language="zh",
                                    batch_size=PACK_BATCH, timestamps=True, logging_steps=1,
                                    device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counters()
        finally:
            PK.decode_audio = decode
        batches = -(-PACK_PACKS // PACK_BATCH)
        expected = label_launches(cfg, batches, PACK_BUDGET - 3)
        log(f"[packed] label_packed large-v2 b{PACK_BATCH}: {PACK_PACKS} packs ({audio_s:.1f} "
            f"s of audio), {batches} batches ({batches * PACK_BATCH - PACK_PACKS} pad rows), "
            f"{PACK_BUDGET - 3} steps each: {PACK_PACKS / wall:.3f} packs/s, "
            f"{audio_s / wall:.2f} audio-s/s (wall {wall:.2f} s; "
            f"{' + '.join(f'{t * 1e3:.1f}' for t in batch_s)} ms by batch, "
            f"{np.mean(batch_s) / (PACK_BUDGET - 3) * 1e3:.3f} ms a step)")
        log(f"[packed] launches {json.dumps(launches)} expected {json.dumps(expected)}")
        if len(batch_s) != batches or launches != expected:
            raise AssertionError(f"label_packed: {len(batch_s)} batches, launch counts "
                                 f"{launches} != expected {expected}")
        add_launches(entries, results, "packed", launches)
        rows = _read_rows(csv_path)
        want = [["id", "condition_on_prev", "whisper_transcript", "text"]] + [
            [p.speaker_id, str(p.condition_on_prev), t, p.text] for p, t in zip(packs, texts)]
        if rows != want or len(texts) != PACK_PACKS or not all(texts):
            raise AssertionError(f"label_packed CSV: {len(rows)} rows, first "
                                 f"{rows[:2]}, want {want[:2]}")
        log(f"[packed] CSV: header + {len(rows) - 1} rows of 4 columns; first transcript "
            f"{texts[0][:80]!r}")

        # card vs CPU: base at the fp32 policy, PACK_AGREE packs, the whole budget
        bcfg = get_config("base")
        bparams = init_params(bcfg, seed=0, device="cpu", dtype=torch.float32)
        sub = packs[:PACK_AGREE]
        cols = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"agree_{dev}.csv")
            t0 = time.perf_counter()
            PK.label_packed(bparams, bcfg, tok, sub, path, DtypePolicy.fp32(), language="zh",
                            batch_size=PACK_AGREE, device=dev)
            log(f"[packed] base fp32 on {dev}: {time.perf_counter() - t0:.1f} s")
            cols[dev] = list(zip(*_read_rows(path)[1:]))
        errors = sum(edit_distance(list(c), list(g)) for c, g in zip(cols["cpu"][2],
                                                                    cols["cuda"][2]))
        chars = sum(len(c) for c in cols["cpu"][2])
        agreement = 1.0 - errors / max(chars, 1)
        same = [cols["cuda"][i] == cols["cpu"][i] for i in (0, 1, 3)]
        log(f"[packed] base fp32 card vs CPU ({PACK_AGREE} packs, {PACK_BUDGET - 3} steps): "
            f"id / condition_on_prev / text equal {same}; transcripts agree on "
            f"{agreement:.4f} of {chars} characters")
        if not all(same) or agreement < 0.98 or not chars:
            raise AssertionError(f"label_packed card vs CPU: columns equal {same}, "
                                 f"character agreement {agreement:.4f} of {chars}")

        # utils/profiling: encode at batch 16 timed inside a trace
        audio = torch.from_numpy(np.stack([pad_or_trim(p.audio, N_SAMPLES)
                                           for p in packs[:PACK_BATCH]])).cuda()
        mel = log_mel(audio, cfg.num_mel_bins)
        trace_dir = os.path.join(tmp, "trace")
        with torch.inference_mode(), profiling.trace(trace_dir):
            enc_s = profiling.device_time(lambda m: M.encode(params, m, cfg, policy), mel,
                                          iters=3)
        [trace_file] = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file), encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"[packed] profiling.device_time(encode, b{PACK_BATCH}): {enc_s * 1e3:.2f} ms a "
            f"call under the profiler; trace {trace_file}: {len(events)} events, {kernels} "
            f"kernel events")
    phase_s = time.perf_counter() - t_phase
    log(f"[packed] phase wall {phase_s:.1f} s")
    results["packed"] = dict(
        packs=PACK_PACKS, batches=batches, audio_s=audio_s, wall_s=wall,
        packs_per_s=PACK_PACKS / wall, audio_s_per_s=audio_s / wall,
        batch_ms=[t * 1e3 for t in batch_s], agreement=agreement, encode_ms=enc_s * 1e3,
        trace_events=len(events), trace_kernel_events=kernels, phase_seconds=phase_s, **facts)


def phase_sweep(torch, entries: dict, results: dict, model_dir: str):
    """``cli sweep --target distill`` through the port's ``cli.main`` in this
    process: a grid of ``SWEEP_LRS`` at ``SWEEP_STEPS`` steps of batch
    ``SWEEP_BATCH`` each, on the large-v2 teacher, a 32-2 student from ``cli
    init-student`` and the train phase's repeated segment. Each run goes
    through a wrapper of ``cli.main`` (the sweep's default runner) that
    logs its wall and peak device memory (reset before it): 2 records, 2
    run directories with their ``hf_export``, ``best.json`` naming a finite
    metric, the second run's peak within 10% of the first's (a teacher or
    optimizer kept alive across runs would show there), launch counters
    zeroed before the sweep and checked after."""
    from taiwan_whisper_tpu_torch import cli, get_config

    t_phase = time.perf_counter()
    cfg = get_config("large-v2")
    with tempfile.TemporaryDirectory() as tmp:
        manifest, tok_dir = _segment_corpus(tmp, 2 * SWEEP_BATCH)
        student_dir = student_32_2(model_dir)
        yaml_path = os.path.join(tmp, "sweep.yaml")
        with open(yaml_path, "w", encoding="utf-8") as f:
            f.write("method: grid\nmetric:\n  goal: minimize\n  name: train/loss\n"
                    "parameters:\n  learning_rate:\n    values: [" +
                    ", ".join(str(x) for x in SWEEP_LRS) + "]\n  max_steps:\n    value: "
                    f"{SWEEP_STEPS}\n  batch_size:\n    value: {SWEEP_BATCH}\n")
        runs = []
        main = cli.main

        def run_main(argv):
            before = read_counters()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                return main(argv)
            finally:
                torch.cuda.synchronize()
                runs.append(dict(wall_s=time.perf_counter() - t0,
                                 peak_bytes=torch.cuda.max_memory_allocated(),
                                 launches={k: n - before[k]
                                           for k, n in read_counters().items()}))

        out = os.path.join(tmp, "sweep")
        cli.main = run_main
        try:
            zero_counters()
            summary = main(["sweep", "--config", yaml_path, "--target", "distill",
                            "--output_dir", out, "--extra", "--manifest", manifest,
                            "--teacher", model_dir, "--student", student_dir,
                            "--warmup_steps", "0", "--language", "zh",
                            "--tokenizer_dir", tok_dir, "--logging_steps", "1"])
            torch.cuda.synchronize()
            launches = read_counters()
        finally:
            cli.main = main
        with open(os.path.join(out, "sweep_results.jsonl"), encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(out, "best.json"), encoding="utf-8") as f:
            best = json.load(f)
        dirs = [r["params"]["output_dir"] for r in records]
        exported = [os.path.exists(os.path.join(d, "hf_export", "model.safetensors"))
                    for d in dirs]
        none = {k: 0 for k in kernel_counters()}
        expected = dict(none, mel=len(SWEEP_LRS) * SWEEP_STEPS,
                        encoder_attention=len(SWEEP_LRS) * SWEEP_STEPS * cfg.encoder_layers,
                        decoder_attention=len(SWEEP_LRS) * SWEEP_STEPS * 2 * cfg.decoder_layers)
        for r, run in zip(records, runs):
            log(f"[sweep] run {r['run']} lr {r['params']['learning_rate']}: "
                f"{r.get('error') or 'loss %.5f' % r['metric']}, wall {run['wall_s']:.1f} s, "
                f"peak {run['peak_bytes'] / 1e9:.3f} GB, launches {json.dumps(run['launches'])}")
        log(f"[sweep] best {best['best'] and best['best']['params']['learning_rate']} "
            f"(metric {best['best'] and best['best']['metric']}); launches "
            f"{json.dumps(launches)} expected {json.dumps(expected)}")
        if len(records) != len(SWEEP_LRS) or len(runs) != len(SWEEP_LRS) or \
                any("error" in r for r in records) or len(set(dirs)) != len(dirs) or \
                not all(exported) or best != json.loads(json.dumps(summary)) or \
                not best["best"] or not np.isfinite(best["best"]["metric"]):
            raise AssertionError(f"cli sweep: records {records}, exported {exported}, "
                                 f"best {best}")
        peaks = [run["peak_bytes"] for run in runs]
        if abs(peaks[1] - peaks[0]) > 0.1 * peaks[0]:
            raise AssertionError(f"cli sweep: run peaks {peaks} differ by more than 10%")
        if launches != expected:
            raise AssertionError(f"sweep launch counts {launches} != expected {expected}")
        add_launches(entries, results, "sweep", launches)
    phase_s = time.perf_counter() - t_phase
    log(f"[sweep] phase wall {phase_s:.1f} s")
    results["sweep"] = dict(runs=runs, metrics=[r["metric"] for r in records],
                            best_lr=best["best"]["params"]["learning_rate"],
                            phase_seconds=phase_s)


def phase_train_agree(torch, results: dict):
    """Three fp32 train steps with the encoder trainable, on the card and
    on the CPU: the card's fp32 kernels (forward with LSE, SIMT backward)
    against the plain path under autograd."""
    from taiwan_whisper_tpu_torch import DtypePolicy, WhisperConfig
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.models.params import (init_params, init_student_from_teacher,
                                                        map_params, named_leaves)
    from taiwan_whisper_tpu_torch.train.distill import DistillConfig, make_train_step
    from taiwan_whisper_tpu_torch.train.state import OptimConfig, make_optimizer, trainable_mask

    resolve_device("cuda")  # TF32 off for the fp32 policy
    cfg = WhisperConfig(vocab_size=512, num_mel_bins=80, d_model=256, ffn_dim=1024,
                        encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                        decoder_attention_heads=4, max_source_positions=300,
                        max_target_positions=32)
    scfg = cfg.with_decoder_layers(1)
    teacher = init_params(cfg, seed=2)
    student = init_student_from_teacher(teacher, cfg, 1)
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        labels = rng.randint(0, 512, (AGREE_BATCH, 16)).astype(np.int32)
        labels[:, :3] = -100
        batches.append({"mel": rng.randn(AGREE_BATCH, 600, 80).astype(np.float32),
                        "decoder_input_ids": rng.randint(0, 512, (AGREE_BATCH, 16)
                                                         ).astype(np.int32),
                        "labels": labels})
    out = {}
    for dev in ("cuda", "cpu"):
        params = map_params(lambda _, t: t.to(dev, copy=True), student)
        tparams = map_params(lambda _, t: t.to(dev, copy=True), teacher)
        opt = make_optimizer(OptimConfig(learning_rate=1e-3, warmup_steps=2),
                             mask=trainable_mask(params, False))
        step = make_train_step(scfg, cfg, DistillConfig(freeze_encoder=False), opt,
                               DtypePolicy.fp32())
        state = opt.init(params)
        zero_counters()
        losses = []
        for b in batches:
            params, state, m = step(params, state, tparams,
                                    {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counters()
        out[dev] = (losses, dict(named_leaves(params)))
    expected = {k: 0 for k in kernel_counters()}
    expected.update(encoder_attention=2 * cfg.encoder_layers * 3,
                    encoder_attention_bwd=cfg.encoder_layers * 3)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    param_err = max(max_abs(out["cuda"][1][p].cpu(), t) for p, t in out["cpu"][1].items())
    log(f"[train_agree] losses card {out['cuda'][0]} cpu {out['cpu'][0]}: max rel diff "
        f"{loss_rel:.3g} (tol 1e-4); params max abs diff {param_err:.3g} (tol 1e-5)")
    log(f"[train_agree] launches {json.dumps(launches)} expected {json.dumps(expected)}")
    if not (loss_rel <= 1e-4 and param_err <= 1e-5):
        raise AssertionError(f"card-vs-CPU train steps disagree: loss {loss_rel:.3g}, "
                             f"params {param_err:.3g}")
    if launches != expected:
        raise AssertionError(f"train_agree launch counts {launches} != expected {expected}")
    results["train_agree"] = dict(loss_rel_diff=loss_rel, param_max_abs_diff=param_err,
                                  launches=launches)


def phase_agree(torch, entries: dict, results: dict):
    from taiwan_whisper_tpu_torch import DtypePolicy, get_config
    from taiwan_whisper_tpu_torch.audio.mel import N_SAMPLES
    from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
    from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.models.params import init_params, prepare_params
    from taiwan_whisper_tpu_torch.ops import mel_kernel
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer

    resolve_device("cuda")  # TF32 off for the fp32 policy
    cfg, pol = get_config("base"), DtypePolicy.fp32()
    tok = WhisperTokenizer()
    rules = DecodeRules.from_special(tok.special, timestamps=True)
    sot = tok.sot_sequence("zh", "transcribe", timestamps=True)
    weights = init_params(cfg, seed=1)
    rng = np.random.RandomState(1)
    audio = torch.from_numpy((rng.randn(AGREE_BATCH, N_SAMPLES) * 0.1).astype(np.float32))
    prefix = torch.tensor([sot] * AGREE_BATCH, dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = prepare_params(weights, pol, dev)
        if dev == "cuda":
            zero_counters()
        with torch.inference_mode():
            enc = M.encode(params, mel_kernel.log_mel(audio.to(dev)), cfg, pol)
        res = greedy_decode(params, enc, prefix, cfg, rules, pol,
                            max_len=len(sot) + AGREE_TOKENS, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counters()
        out[dev] = res.tokens[:, len(sot):].cpu().numpy()
    # Steps the card's loop ran: every row has emitted eot after step
    # `done`, and the loop polls for that every 8 steps (decode/greedy.py).
    eot_at = [np.flatnonzero(row == rules.eot) for row in out["cuda"]]
    done = max((e[0] if len(e) else AGREE_TOKENS) for e in eot_at)
    steps = min(AGREE_TOKENS, -(-(done + 1) // 8) * 8)
    expected = {"mel": 1, "encoder_attention": cfg.encoder_layers, "encoder_attention_bwd": 0,
                "decoder_attention": 0,
                "cross_decode_attention": cfg.decoder_layers * (1 + steps),
                "self_decode_attention": cfg.decoder_layers * steps, "layer_norm": 0}
    log(f"[agree] launches {json.dumps(launches)} expected {json.dumps(expected)}")
    if launches != expected:
        raise AssertionError(f"agree launch counts {launches} != expected {expected}")
    same = out["cuda"] == out["cpu"]
    agreement = float(same.mean())
    mism = np.argwhere(~same)
    first = None if len(mism) == 0 else dict(
        row=int(mism[0][0]), pos=int(mism[0][1]),
        cuda=int(out["cuda"][tuple(mism[0])]), cpu=int(out["cpu"][tuple(mism[0])]))
    log(f"[agree] base fp32, batch {AGREE_BATCH}, {AGREE_TOKENS} tokens: card-vs-CPU token "
        f"agreement {agreement:.4f}, first mismatch {first}")
    if agreement < 0.98:
        raise AssertionError(f"card-vs-CPU token agreement {agreement:.4f} < 0.98")
    results["agree"] = dict(agreement=agreement, first_mismatch=first, launches=launches)

    # beam search, 5 beams, the same inputs: card vs CPU
    from taiwan_whisper_tpu_torch.decode.beam import beam_decode

    beam_out = {}
    for dev in ("cuda", "cpu"):
        params = prepare_params(weights, pol, dev)
        if dev == "cuda":
            zero_counters()
        with torch.inference_mode():
            enc = M.encode(params, mel_kernel.log_mel(audio.to(dev)), cfg, pol)
        res = beam_decode(params, enc, prefix, cfg, rules, pol, num_beams=BEAMS,
                          max_len=len(sot) + AGREE_TOKENS, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counters()
        beam_out[dev] = res.all_tokens[:, :, len(sot):].cpu().numpy()
    # a step is one cross and one self launch a layer, the prefill one cross
    steps = launches["self_decode_attention"] // cfg.decoder_layers
    consistent = (launches["mel"] == 1 and launches["encoder_attention"] == cfg.encoder_layers
                  and launches["self_decode_attention"] == cfg.decoder_layers * steps
                  and launches["cross_decode_attention"] == cfg.decoder_layers * (1 + steps)
                  and 0 < steps <= AGREE_TOKENS)
    beam_agreement = float((beam_out["cuda"] == beam_out["cpu"]).mean())
    log(f"[agree] beam {BEAMS}, base fp32, batch {AGREE_BATCH}, {AGREE_TOKENS} tokens: card-vs-CPU "
        f"agreement of all hypotheses' tokens {beam_agreement:.4f}; launches "
        f"{json.dumps(launches)} ({steps} steps)")
    if not consistent:
        raise AssertionError(f"agree beam launch counts {launches} do not fit {steps} steps")
    if beam_agreement < 0.98:
        raise AssertionError(f"card-vs-CPU beam token agreement {beam_agreement:.4f} < 0.98")
    results["agree"].update(beam_agreement=beam_agreement, beam_launches=launches)
    agree_quantized(torch, entries, results, weights, cfg, audio, prefix, rules)
    agree_speculative(torch, results, weights, cfg, audio, sot, rules)


def first_mismatch(a, b):
    """(agreement, the first diverging (row, position) with both tokens)."""
    same = a == b
    mism = np.argwhere(~same)
    first = None if len(mism) == 0 else dict(
        row=int(mism[0][0]), pos=int(mism[0][1]), cuda=int(a[tuple(mism[0])]),
        cpu=int(b[tuple(mism[0])]))
    return float(same.mean()), first


def agree_quantized(torch, entries, results, weights, cfg, audio, prefix, rules):
    """Greedy with int4 and with "8x8" cross K/V, base at fp32, batch 4:
    card vs CPU tokens agree on at least 0.98 of positions; the card's run
    launches mel once, the encoder's layers and, a step, one cross and one
    self launch a layer (the prefill one cross more)."""
    from taiwan_whisper_tpu_torch import DtypePolicy
    from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.params import prepare_params
    from taiwan_whisper_tpu_torch.ops import mel_kernel

    pol = DtypePolicy.fp32()
    for quant in (4, "8x8"):
        out = {}
        for dev in ("cuda", "cpu"):
            params = prepare_params(weights, pol, dev)
            if dev == "cuda":
                zero_counters()
            with torch.inference_mode():
                enc = M.encode(params, mel_kernel.log_mel(audio.to(dev)), cfg, pol)
            res = greedy_decode(params, enc, prefix, cfg, rules, pol,
                                max_len=prefix.shape[1] + AGREE_TOKENS, quantize_cross_kv=quant,
                                device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_counters()
            out[dev] = res.tokens[:, prefix.shape[1]:].cpu().numpy()
        steps = launches["self_decode_attention"] // cfg.decoder_layers
        if not (launches["mel"] == 1 and launches["encoder_attention"] == cfg.encoder_layers
                and launches["self_decode_attention"] == cfg.decoder_layers * steps
                and launches["cross_decode_attention"] == cfg.decoder_layers * (1 + steps)
                and 0 < steps <= AGREE_TOKENS):
            raise AssertionError(f"agree greedy {quant!r} launch counts {launches} do not fit "
                                 f"{steps} steps")
        add_launches(entries, results, f"agree_{quant}", launches)
        agreement, first = first_mismatch(out["cuda"], out["cpu"])
        log(f"[agree] greedy quantize {quant!r}, base fp32, batch {AGREE_BATCH}: card-vs-CPU "
            f"token agreement {agreement:.4f}, first mismatch {first}")
        results["agree"][f"greedy_{quant}"] = dict(agreement=agreement, first_mismatch=first)
        if agreement < 0.98:
            raise AssertionError(f"card-vs-CPU greedy {quant!r} agreement {agreement:.4f} < 0.98")


def agree_speculative(torch, results, weights, cfg, audio, sot, rules):
    """``speculative_decode`` on the card against the card's own teacher
    ``greedy_decode`` (the greedy-exact property) on the first utterance,
    base teacher, ``SPEC_TOKENS`` tokens: with its 2-layer distilled
    student (``init_student_from_teacher``, shared encoder) and with the
    teacher as its own assistant, whose accept rate must exceed 0.9, both
    at fp32 (agreement at least 0.98); the same two at bf16 are logged only:
    extend's 6-row GEMMs and decode_step's 1-row GEMMs round differently."""
    from taiwan_whisper_tpu_torch import DtypePolicy
    from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
    from taiwan_whisper_tpu_torch.decode.speculative import speculative_decode
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.params import init_student_from_teacher, prepare_params
    from taiwan_whisper_tpu_torch.ops import mel_kernel

    scfg = cfg.with_decoder_layers(2)
    student_w = init_student_from_teacher(weights, cfg, 2)
    prefix = torch.tensor([sot], dtype=torch.int32)
    max_len = len(sot) + SPEC_TOKENS
    out = {}
    for name, pol in (("fp32", DtypePolicy.fp32()), ("bf16", DtypePolicy())):
        teacher = prepare_params(weights, pol, "cuda")
        with torch.inference_mode():
            enc = M.encode(teacher, mel_kernel.log_mel(audio[:1].cuda()), cfg, pol)
        greedy = greedy_decode(teacher, enc, prefix, cfg, rules, pol, max_len=max_len,
                               device="cuda").tokens.cpu().numpy()
        for kind, sparams, s_cfg in (("student", prepare_params(student_w, pol, "cuda"), scfg),
                                     ("teacher", teacher, cfg)):
            t0 = time.perf_counter()
            res = speculative_decode(teacher, cfg, sparams, s_cfg, enc, enc, prefix, rules, pol,
                                     num_draft_tokens=DRAFTS, max_len=max_len, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            agreement, first = first_mismatch(res.tokens.cpu().numpy()[:, len(sot):],
                                              greedy[:, len(sot):])
            log(f"[agree] speculative {name}, base teacher, {kind} drafting (k {DRAFTS}): "
                f"agreement with the card's greedy {agreement:.4f}, first mismatch {first}; "
                f"{res.rounds} rounds, draft accept rate {res.draft_accept_rate:.4f}, "
                f"{res.length} tokens in {secs:.3f} s")
            out[f"{name}_{kind}"] = dict(agreement=agreement, first_mismatch=first,
                                         rounds=res.rounds, accept=res.draft_accept_rate)
            if name == "fp32" and agreement < 0.98:
                raise AssertionError(f"speculative ({kind}) vs greedy agreement {agreement:.4f} "
                                     f"< 0.98 at fp32")
            if name == "fp32" and kind == "teacher" and not res.draft_accept_rate > 0.9:
                raise AssertionError(f"the teacher drafting for itself accepted "
                                     f"{res.draft_accept_rate:.4f} <= 0.9")
    results["agree"]["speculative"] = out


def main(argv) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    try:
        import taiwan_whisper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    if argv[:1] == ["_rank"]:
        return rank_main(argv[1:])
    if argv[:1] == ["_tp_rank"]:
        return tp_rank_main(argv[1:])
    t_start = time.perf_counter()
    phases = argv or ["kernels", "label", "label_vad", "label_beam", "longform", "speculative",
                      "prefilter", "train", "distributed", "tensor_parallel", "packed", "sweep",
                      "train_agree", "agree"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    walls = {}

    def timed(name, fn, *args):
        """Run one phase and log its wall."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"[smoke] phase {name}: {walls[name]:.1f} s")
        return out

    timed("build", phase_build)
    entries, checks, results, case_rows = {}, [], {}, []
    groups = [p for p in phases if p in ("mel", "layer_norm")]
    if "kernels" in phases or groups:
        timed("kernels", phase_kernels, torch, entries, checks, case_rows,
              None if "kernels" in phases else groups)
        log("checks " + json.dumps({"checks": checks}))
    large_v2_phases = {
        "label": phase_label, "label_vad": phase_label_vad, "label_beam": phase_label_beam,
        "longform": phase_longform, "speculative": phase_speculative, "train": phase_train,
        "distributed": phase_distributed, "tensor_parallel": phase_tensor_parallel,
        "packed": phase_packed, "sweep": phase_sweep}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = (timed("large_v2_checkpoint", write_large_v2, tmp, torch)
                     if set(large_v2_phases) & set(phases) else None)
        for name in ("label", "label_vad", "label_beam", "longform", "speculative",
                     "prefilter", "train", "distributed", "tensor_parallel", "packed", "sweep"):
            if name == "prefilter" and name in phases:
                timed(name, phase_prefilter, torch, entries, results)
            elif name in phases:
                timed(name, large_v2_phases[name], torch, entries, results, model_dir)
    if "train_agree" in phases:
        timed("train_agree", phase_train_agree, torch, results)
    if "agree" in phases:
        timed("agree", phase_agree, torch, entries, results)
    results["phase_walls_s"] = walls
    log("results " + json.dumps(results))
    log(f"[smoke] phases {' '.join(phases)}: {time.perf_counter() - t_start:.1f} s")
    # every kernel case; launches are the kernel's, all its shapes, not the
    # case's: summed over the driven paths and, in launches_by_path, by path
    counted = {r["name"]: entries.get(COUNTER_OF.get(r["name"], r["name"]), {})
               for r in case_rows}
    log(json.dumps({"kernels": [dict(name=r["name"], case=r["case"], route=r["route"],
                                     source=r["source"], replaces=r["replaces"],
                                     launches=counted[r["name"]].get("launches", 0),
                                     launches_by_path=counted[r["name"]].get("by_path", {}),
                                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                     bound_by=r["bound_by"], library_ms=r["library_ms"])
                                for r in case_rows]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
