"""Where the time of one labelling batch goes, on the card.

    python -m taiwan_whisper_tpu_torch.tools.profile_label [--preset large-v2]
        [--batch 32] [--tokens 192] [--quantize fp8]
    # one batch of the prefilter's validator (configs/prefilter_base_0.4.args)
    python -m taiwan_whisper_tpu_torch.tools.profile_label --preset base \
        --batch 64 --tokens 445 --quantize 0

Random bf16 weights from a seed, one batch of 30 s chunks of random audio.
Times each stage of ``pipeline.label.decode_batch`` with the host clock
around synchronised work (mel, encode, cross-KV precompute, prefill, the
greedy loop), then traces a window of decode steps with torch.profiler and
prints device time by kernel and the device's busy share of the window.
The VAD stage: the device spectral scorer on one call of 8 segments of
120 s of speech-like audio (``tools/synth_audio.py``, int16 wire), ms per
call with the copies to and from the card, and the seconds the VAD keeps
of the seconds in. Prints one JSON object as its last line; writes the
trace under ``chiprun_out/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..audio.mel import N_SAMPLES
from ..decode.greedy import greedy_decode
from ..decode.rules import DecodeRules
from ..models import whisper as M
from ..models.config import DtypePolicy, get_config, resolve_device
from ..models.params import init_params, prepare_params
from ..ops.mel_kernel import log_mel
from ..pipeline import vad
from ..text.tokenizer import WhisperTokenizer
from .synth_audio import synth_lecture


STEPS_TRACED = 8
VAD_CALLS = 5


def vad_stage(dev) -> dict:
    """The device scorer on one call's worth of speech-like segments."""
    rng = np.random.RandomState(0)
    n = vad._VAD_SEG_SAMPLES
    audios = [synth_lecture(rng, n / vad.SAMPLE_RATE)[:n] for _ in range(vad._VAD_CALL_SEGS)]
    segs = np.concatenate([vad._file_segments(a) for a in audios])
    vad._score_segments(segs, dev)  # warm-up: cuFFT plans, allocator
    times = []
    for _ in range(VAD_CALLS):
        _, ms = _timed(lambda: vad._score_segments(segs, dev))
        times.append(ms)
    regions = vad.spectral_regions_device_batch(audios, dev)
    kept = sum(b - a for r in regions for a, b in r)
    return dict(vad_segments_per_call=len(segs), vad_call_ms=float(np.median(times)),
                vad_call_ms_all=times, vad_seconds_in=len(segs) * n / vad.SAMPLE_RATE,
                vad_seconds_kept=kept)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="large-v2")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=192)
    ap.add_argument("--quantize", default="fp8")
    args = ap.parse_args(argv)
    quantize = {"0": 0, "8": 8}.get(args.quantize, args.quantize)

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg, pol = get_config(args.preset), DtypePolicy()
    params = prepare_params(init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16),
                            pol, dev)
    tok = WhisperTokenizer()
    rules = DecodeRules.from_special(tok.special)
    sot = tok.sot_sequence("zh", "transcribe", timestamps=True)
    prefix = torch.tensor([sot] * args.batch, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn((args.batch, N_SAMPLES), generator=gen, device=dev) * 0.1
    max_len = len(sot) + args.tokens

    def run(budget):
        with torch.inference_mode():
            mel, t_mel = _timed(lambda: log_mel(audio, cfg.num_mel_bins))
            enc, t_enc = _timed(lambda: M.encode(params, mel, cfg, pol))
            kv, t_kv = _timed(lambda: M.precompute_cross_kv(params, enc, cfg, pol,
                                                            quantize=quantize))
            cache = M.init_cache(cfg, args.batch, len(sot) + budget, dtype=pol.compute_dtype,
                                 device=dev)
            _, t_pre = _timed(lambda: M.prefill(params, kv, cache, prefix, cfg, pol))
            del kv, cache
            res, t_all = _timed(lambda: greedy_decode(
                params, enc, prefix, cfg, rules, pol, max_len=len(sot) + budget,
                quantize_cross_kv=quantize, device=dev))
        return res, dict(mel_ms=t_mel, encode_ms=t_enc, cross_kv_ms=t_kv,
                         prefill_ms=t_pre, greedy_decode_ms=t_all)

    # warm-up: kernel builds, first launches, allocator, cuBLAS handles
    _, warmup_ms = _timed(lambda: run(8))
    res, stages = run(args.tokens)
    stages["warmup_ms"] = warmup_ms
    steps = int(max_len - len(sot))
    loop_ms = stages["greedy_decode_ms"] - stages["cross_kv_ms"] - stages["prefill_ms"]
    stages["decode_loop_ms"] = loop_ms
    stages["step_ms"] = loop_ms / steps
    batch_ms = stages["mel_ms"] + stages["encode_ms"] + stages["greedy_decode_ms"]
    stages["audio_s_per_s"] = args.batch * 30.0 / (batch_ms / 1e3)
    stages.update(vad_stage(dev))

    # trace a window of decode steps
    with torch.inference_mode():
        enc = M.encode(params, log_mel(audio, cfg.num_mel_bins), cfg, pol)
        kv = M.precompute_cross_kv(params, enc, cfg, pol, quantize=quantize)
        cache = M.init_cache(cfg, args.batch, max_len, dtype=pol.compute_dtype, device=dev)
        M.prefill(params, kv, cache, prefix, cfg, pol)
        token = prefix[:, -1]
        for i in range(len(sot), len(sot) + 2):
            M.decode_step(params, kv, cache, token, i, cfg, pol)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(len(sot) + 2, len(sot) + 2 + STEPS_TRACED):
                M.decode_step(params, kv, cache, token, i, cfg, pol)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy/memset): the CPU-side aten
    # ops carry the same device time again as their children's
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "decode_steps_trace.json"))
    print(card)
    print(f"stages (ms, batch {args.batch}, {steps} tokens): " + json.dumps(stages))
    print(f"vad: {stages['vad_call_ms']:.2f} ms per call of {stages['vad_segments_per_call']} "
          f"x 120 s segments; kept {stages['vad_seconds_kept']:.1f} s of "
          f"{stages['vad_seconds_in']:.1f} s")
    busy_step = busy_ms / STEPS_TRACED
    print(f"decode window: {STEPS_TRACED} steps, traced wall {window_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms; {busy_step:.3f} ms busy per step = "
          f"{100 * busy_step / stages['step_ms']:.1f}% of the untraced step")
    for ms, n, name in rows[:20]:
        print(f"  {ms / STEPS_TRACED:9.4f} ms/step  {n // STEPS_TRACED:5d}/step  "
              f"{name[:90]}")
    print(json.dumps({"card": card, "preset": args.preset, "batch": args.batch,
                      "tokens": args.tokens, "quantize": args.quantize, "stages": stages,
                      "window_steps": STEPS_TRACED, "window_ms": window_ms,
                      "device_busy_ms": busy_ms,
                      "top_kernels": [dict(name=n[:120], ms_per_step=ms / STEPS_TRACED,
                                           calls_per_step=c / STEPS_TRACED)
                                      for ms, c, n in rows[:20]]}))


if __name__ == "__main__":
    main()
