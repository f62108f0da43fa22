"""Window driver of the labelling entry point,
``pipeline/label.py::label_files``.

Set-up: seeded weights on the device (``weights.py``) through
``models/params.py::load_hf_state_dict``; a pool of lectures written as
PCM16 WAV, the same for every seed (``POOL_SEED``); one warm call of
``label_files`` over one full batch of bursts (it loads every kernel and
fills the caches).
The window is one call of ``label_files`` over a corpus of pieces of the
pool's lectures (hard links: a file may repeat, nothing in the port caches
by content) that holds the traffic file's ``batches`` whole batches of
30 s chunks (``ctx.batches`` in the readings), as the reference's VAD and
chunking count them. The work is fixed: the same pieces, so the same
audio and the same chunks, for every run and seed, written in a seeded
order. A pool drawn from the seed chunked differently under the VAD, and
its corpus of so many chunks held 5,422-5,595 s of audio by seed; sizing
the window from a timed warm batch, which read 4.6-6.3 s on one H100
host, put 7-9 batches in it. Both spread the rate. Its rate is the audio
sent over the call's wall. The reference's VAD, which cuts the corpus to
whole batches, runs in set-up but is not counted in ``setup_s``.

``label.decode_audio`` is wrapped for the run: before each batch the
wrapper takes the fingerprint of every audio row, and it keeps the tokens
and lengths that the batch returns, for ``reference/label_check.py`` and
for the model FLOPs of the rows (``roofline/whisper_flops.py``, from each
real row's served tokens). In a ``--trace 1`` run it also marks each
``models.whisper.decode_step`` as a step and traces two stretches of one
batch of the window: the ``encode`` stretch (log-mel, encoder, cross-K/V,
prefill) and the ``loop`` stretch (``trace.loop_steps`` steps of the
decode loop from ``trace.loop_from``). A ``decode_step`` captured into a
CUDA graph (``trace.Graphs``) is marked inside the capture and runs at
the graph's replays: a replay of a graph that captured k steps counts as
k steps for the stretches, which start and stop only outside a capture.
Each batch's wall and the launching thread's CPU seconds in it go to
standard error, with the audio and the window's wall.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from port_bench import harness, synth
from port_bench import weights as W
from port_bench.reference import audio as RA
from port_bench.reference import label_check
from port_bench.roofline import whisper_flops as F
from port_bench.trace import STEP_RANGE, graph_id

POOL_SEED = 0  # the lectures' audio: the same for every --seed


class _Capture:
    """The wrappers around ``decode_audio`` and ``decode_step``."""

    def __init__(self, ctx, chunk_len: int):
        self.ctx = ctx
        self.tr = ctx.traffic.get("trace", {})
        self.w = RA.fingerprint_weights(ctx.torch_seed("fingerprint"), chunk_len,
                                                   ctx.device)
        self.batches = []
        self.walls = []
        self.cpu = []  # the launching thread's CPU seconds in each batch
        self.recording = False
        self.step_in_batch = 0
        self.graph_steps = {}  # graph id -> decode steps captured in it

    def fingerprint(self, audio: torch.Tensor) -> torch.Tensor:
        return torch.cat([((audio[i:i + 8].double() * 32768.0).round() @ self.w).round().long()
                          for i in range(0, audio.shape[0], 8)])

    def decode_audio(self, orig):
        def wrapped(params, audio, prefix, *args, **kwargs):
            batch_no = len(self.batches)
            fp = self.fingerprint(audio)
            self.step_in_batch = 0
            enc = self.ctx.stretch("encode")
            if (self.recording and self.ctx.trace and enc.wanted
                    and batch_no >= self.tr.get("batch", 1)):
                enc.start()
            if self.recording and self.ctx.device.type == "cuda":
                harness.pin_launcher()  # threads the port started since
            t, c = time.perf_counter(), time.thread_time()
            res = orig(params, audio, prefix, *args, **kwargs)
            for s in (enc, self.ctx.stretch("loop")):
                if s.active:
                    s.stop()
            if self.recording:
                self.walls.append(time.perf_counter() - t)
                self.cpu.append(time.thread_time() - c)
                self.batches.append(dict(fp=fp, tokens=res.tokens, lengths=res.lengths,
                                         sum_logprobs=res.sum_logprobs))
            return res
        return wrapped

    def _steps_begin(self, k: int):
        """Before ``k`` decode steps run on the device: the encode stretch
        ends; the loop stretch starts if its first step is among them."""
        enc, loop = self.ctx.stretch("encode"), self.ctx.stretch("loop")
        if enc.active:
            enc.stop()
        first = self.tr.get("loop_from", 64)
        if (self.recording and loop.wanted and len(self.batches) >= self.tr.get("batch", 1)
                and self.step_in_batch <= first < self.step_in_batch + k):
            loop.start()
        self.step_in_batch += k
        return loop

    def _steps_end(self, loop):
        if loop.active and (self.step_in_batch
                            >= self.tr.get("loop_from", 64) + self.tr.get("loop_steps", 16)):
            loop.stop()

    def decode_step(self, orig):
        def wrapped(*args, **kwargs):
            cap = self.ctx.capturing()
            if cap is not None:  # runs at the graph's replays
                self.graph_steps[cap.gid] = self.graph_steps.get(cap.gid, 0) + 1
                with torch.profiler.record_function(STEP_RANGE):
                    return orig(*args, **kwargs)
            loop = self._steps_begin(1)
            if loop.active:
                with torch.profiler.record_function(STEP_RANGE):
                    out = orig(*args, **kwargs)
                self._steps_end(loop)
                return out
            return orig(*args, **kwargs)
        return wrapped

    def replay(self, orig):
        """``torch.cuda.CUDAGraph.replay``: a graph that captured decode
        steps replays them."""
        def wrapped(graph, *args, **kwargs):
            k = self.graph_steps.get(graph_id(graph), 0)
            if not k or self.ctx.capturing() is not None:
                return orig(graph, *args, **kwargs)
            loop = self._steps_begin(k)
            out = orig(graph, *args, **kwargs)
            self._steps_end(loop)
            return out
        return wrapped


def chunk_starts(lec, chunk_len: int, stride: int, device):
    """The first sample of each 30 s chunk that the reference's VAD and
    chunking give this lecture alone."""
    regions = RA.corpus_regions([lec.pcm], device)[0]
    return [s for _, s, _ in RA.corpus_chunks([regions], chunk_len, stride)]


def corpus(pool, starts, chunks: int, rng, out_dir: str):
    """Pieces of the pool's lectures that hold ``chunks`` chunks (whole
    batches; ``starts``: each pool lecture's chunk starts): whole lectures
    in the pool's order, the last cut in the gap after a burst. The pieces
    are the same for every ``rng``; it draws the order they are written in
    (hard links where whole)."""
    pieces, held = [], 0
    while held < chunks:
        for i, lec in enumerate(pool):
            need = chunks - held
            if need <= 0:
                break
            if len(starts[i]) <= need:
                pieces.append((i, None))
                held += len(starts[i])
            else:
                cuts = [(a[1] + b[0]) // 2 for a, b in zip(lec.bursts, lec.bursts[1:])]
                fit = [(sum(s < c for s in starts[i]), c) for c in cuts]
                n, cut = max((f for f in fit if 0 < f[0] <= need), default=fit[0])
                pieces.append((i, cut))
                held += n
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, j in enumerate(rng.permutation(len(pieces))):
        i, cut = pieces[int(j)]
        dst = os.path.join(out_dir, f"lecture{k:04d}.wav")
        if cut is None:
            synth.link_or_copy(pool[i].path, dst)
        else:
            synth.write_wav(dst, pool[i].pcm[:cut])
        paths.append(dst)
    return paths


def run(ctx, *, t_start: float) -> dict:
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import DtypePolicy
    from taiwan_whisper_tpu_torch.models.io import config_from_hf_dict
    from taiwan_whisper_tpu_torch.models.params import load_hf_state_dict
    from taiwan_whisper_tpu_torch.pipeline import label as L
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer

    tr, dev = ctx.traffic, ctx.device
    hf = W.hf_config(ctx.config)
    config = config_from_hf_dict(hf)
    sd = W.make_state_dict(hf, ctx.torch_seed("weights"), dev)
    params = load_hf_state_dict(sd, config)
    policy = DtypePolicy.bf16()
    tok = WhisperTokenizer()
    lc = L.LabelConfig(**tr["label"])
    chunk_len = config.max_source_positions * 2 * 160
    stride = int(chunk_len // 6)

    lect = tr["lectures"]
    pool = synth.lecture_pool(harness.rng(POOL_SEED, "lectures"),
                              os.path.join(ctx.workdir, "pool"), lect["seconds"],
                              lect["noise_dbfs"], lect.get("base_s", 300.0))

    def call(paths, out):
        return L.label_files(params, config, tok, paths, os.path.join(ctx.workdir, out), lc,
                             policy, device=dev, log_every=0)

    cap = _Capture(ctx, chunk_len)
    ctx.patch(L, "decode_audio", cap.decode_audio)
    if ctx.trace:
        ctx.patch(M, "decode_step", cap.decode_step)
        ctx.patch(torch.cuda.CUDAGraph, "replay", cap.replay)

    t_ref = time.perf_counter()
    starts = [chunk_starts(lec, chunk_len, stride, dev) for lec in pool]
    t_ref = time.perf_counter() - t_ref  # the reference's: not set-up
    w = lect["warm"]
    warm = corpus([pool[w]], [starts[w]], lc.batch_size, ctx.rng("warm"),
                  os.path.join(ctx.workdir, "warm"))
    call(warm, "out_warm")
    n_batches = ctx.batches or tr["batches"]
    paths = corpus(pool, starts, lc.batch_size * n_batches, ctx.rng("order"),
                   os.path.join(ctx.workdir, "corpus"))

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    harness.settle(dev)
    cap.recording = True
    setup_s = time.time() - t_start - t_ref
    t0 = time.perf_counter()
    stats = call(paths, "out")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    cap.recording = False
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    # what the caching allocator held at most: the card memory the job takes
    reserved = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else None

    batches = [{k: v.cpu().numpy() for k, v in b.items()} for b in cap.batches]
    prefix = tok.sot_sequence(lc.language, lc.task, timestamps=True)
    flops = sum(F.label_row_flops(ctx.config, prefix=len(prefix), tokens=int(n))
                for b in batches for f, n in zip(b["fp"], b["lengths"]) if f != 0)
    print("[port_bench] batch walls (s): " + " ".join(f"{x:.3f}" for x in cap.walls)
          + "; launcher CPU (s): " + " ".join(f"{x:.3f}" for x in cap.cpu)
          + f"; audio {stats['audio_seconds']:.2f} s in {window_s:.3f} s"
          + f"; reference VAD in set-up {t_ref:.2f} s"
          + f"; peak allocated {peak_window} B, reserved {reserved} B", file=sys.stderr)
    record = dict(stats=stats, window_s=window_s, batch_size=lc.batch_size,
                  peak_bytes=peak_window, model_flops=flops)
    del params
    files = [synth.read_wav(p) for p in paths]

    def check(control: bool = False):
        return label_check.check(
            weights=sd, cfg=ctx.config, files=files, batches=batches, prefix=prefix,
            chunk_len=chunk_len, stride=stride, fp_seed=ctx.torch_seed("fingerprint"),
            sample=tr["check"]["sample_rows"], rng=ctx.rng("check"), limits=tr["limits"],
            device=dev, beams=lc.num_beams, control=control)

    held_gb = reserved / 1e9 if reserved else None  # none without a card
    return {"e2e": {"label_peak_gb": held_gb, "setup_s": setup_s},
            "attempted": stats["chunks"], "record": record, "check": check}
