"""Where the time of one labelling batch goes, on the card.

    python -m taiwan_whisper_tpu_torch.tools.profile_label [--preset large-v2]
        [--batch 32] [--tokens 192] [--quantize fp8]
    # one batch of the prefilter's validator (configs/prefilter_base_0.4.args)
    python -m taiwan_whisper_tpu_torch.tools.profile_label --preset base \
        --batch 64 --tokens 445 --quantize 0
    # one batch of configs/label_large_v2_beam.args (beam 5, int8)
    python -m taiwan_whisper_tpu_torch.tools.profile_label --batch 8 --quantize 8 \
        --num_beams 5 [--prompt_tokens 223]
    # int4 (packed) or "8x8" (int8 x int8 dots) cross K/V in the greedy step
    python -m taiwan_whisper_tpu_torch.tools.profile_label --quantize 4
    python -m taiwan_whisper_tpu_torch.tools.profile_label --quantize 8x8
    # one speculative window: the 32-2 student drafts, large-v2 verifies
    python -m taiwan_whisper_tpu_torch.tools.profile_label --assistant \
        [--num_draft_tokens 5] [--tokens 192]

Random bf16 weights from a seed, one batch of 30 s chunks of random audio.
Times each stage of ``pipeline.label.decode_batch`` with the host clock
around synchronised work (mel, encode, cross-KV precompute, prefill, the
greedy or beam loop), then traces a window of decode steps with
torch.profiler and prints device time by kernel and the device's busy
share of the window. A second trace covers the whole loop (the step, then
the rules and argmax, or the rules, top-k and cache reorder of beam
search): the kernels of a run of ``--tokens`` + 8 steps less those of a
run of ``--tokens``, per step, beside the untraced step time.
``--num_beams`` K decodes with beam search (the self cache has B x K rows,
the cross kernel K rows an item a step); ``--prompt_tokens`` P puts a
prompt of <|startofprev|> and P tokens before the sot sequence, so the
prefill's cross kernel takes (P + 4) x K rows an item.
The VAD stage: the device spectral scorer on one call of 8 segments of
120 s of speech-like audio (``tools/synth_audio.py``, int16 wire), ms per
call with the copies to and from the card, and the seconds the VAD keeps
of the seconds in. Prints one JSON object as its last line; writes the
trace under ``chiprun_out/``.

``--assistant`` profiles one speculative window instead (batch 1, one
30 s chunk, ``--tokens`` sampled tokens): the 32-2 student
(``init_student_from_teacher``, sharing the encoder) drafts
``--num_draft_tokens`` tokens a round and the teacher verifies them with
``extend``. Its wall, rounds, accept rate, launches (the kernels' counters
and the host's launch calls, from torch.profiler) and device busy share,
then the same window with each student step, each ``extend`` and each
rule pick synchronised on both sides: ms per call of each.
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
from ..decode import speculative as S
from ..decode.beam import beam_decode
from ..decode.greedy import cross_kv_mode, greedy_decode
from ..decode.rules import DecodeRules
from ..models import whisper as M
from ..models.config import DtypePolicy, get_config, resolve_device
from ..models.params import init_params, init_student_from_teacher, prepare_params
from ..ops import attention, decode_attention, mel_kernel
from ..ops.mel_kernel import log_mel
from ..pipeline import vad
from ..text.tokenizer import WhisperTokenizer
from .synth_audio import synth_lecture


STEPS_TRACED = 8
VAD_CALLS = 5
# the aten ops of the beam loop's cache reorder and top-k (the reorder's
# strided index_select runs a generic gather kernel no name tells apart)
PARTS = {"reorder": "aten::index_select", "top_k": "aten::topk"}


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


def _device_kernels(prof):
    """(device ms, count) by kernel name of a trace, its host launch calls,
    and the device ms under each of ``PARTS``' ops."""
    avg = prof.key_averages()
    kernels = {e.key: (e.self_device_time_total / 1e3, e.count) for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    launches = sum(e.count for e in avg if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith(("cudaLaunch", "cuLaunch")))
    ops = {name: sum(e.device_time_total / 1e3 for e in avg if e.key == op)
           for name, op in PARTS.items()}
    return kernels, launches, ops


def loop_window(decode, budget: int) -> dict:
    """Per loop step: the kernels of ``decode(budget + STEPS_TRACED)`` less
    those of ``decode(budget)`` (torch.profiler), the host launch calls, and
    the untraced wall of the same difference."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    traced, walls = {}, {}
    for n in (budget, budget + STEPS_TRACED):
        _, walls[n] = _timed(lambda: decode(n))
        with torch.profiler.profile(activities=acts) as prof:
            decode(n)
            torch.cuda.synchronize()
        traced[n] = _device_kernels(prof)
    (small, l0, o0), (big, l1, o1) = traced[budget], traced[budget + STEPS_TRACED]
    rows = sorted(((ms - small.get(k, (0.0, 0))[0]) / STEPS_TRACED,
                   (n - small.get(k, (0.0, 0))[1]) / STEPS_TRACED, k)
                  for k, (ms, n) in big.items())[::-1]
    step_ms = (walls[budget + STEPS_TRACED] - walls[budget]) / STEPS_TRACED
    busy = sum(r[0] for r in rows)
    parts = {name: (o1[name] - o0[name]) / STEPS_TRACED for name in PARTS}
    return dict(step_ms=step_ms, busy_ms=busy, idle_share=1.0 - busy / step_ms,
                launch_calls=(l1 - l0) / STEPS_TRACED, parts_ms=parts,
                kernels=[dict(name=k[:120], ms_per_step=ms, calls_per_step=c)
                         for ms, c, k in rows[:20]])


def speculative_window(params, cfg, pol, audio, sot, rules, tokens: int, drafts: int,
                       dev) -> dict:
    """One speculative window at ``cfg`` with its 2-decoder-layer student:
    see the module docstring."""
    scfg = cfg.with_decoder_layers(2)
    student = init_student_from_teacher(params, cfg, 2)
    prefix = torch.tensor([sot], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        enc = M.encode(params, log_mel(audio[:1], cfg.num_mel_bins), cfg, pol)

    def window():
        return S.speculative_decode(params, cfg, student, scfg, enc, enc, prefix, rules, pol,
                                    num_draft_tokens=drafts, max_len=len(sot) + tokens,
                                    device=dev)

    window()  # warm-up
    counters = {"cross": decode_attention.cross_attention,
                "self": decode_attention.self_attention, "mel": mel_kernel.log10_mel_spectrum,
                "encoder": attention.encoder_attention}
    for fn in counters.values():
        fn.launches = 0
    decode_attention.cross_attention.launches_by_rows = {}
    res, wall_ms = _timed(window)
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["cross_by_rows"] = dict(decode_attention.cross_attention.launches_by_rows)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, launch_calls, _ = _device_kernels(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())

    # each part synchronised on both sides: its own ms per call
    parts = {"student_step": [], "teacher_step": [], "extend": [], "pick": []}
    saved = M.decode_step, M.extend, S.apply_rules

    def synced(name_of, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[name_of(args)].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    M.decode_step = synced(lambda a: "student_step" if a[0] is student else "teacher_step",
                           saved[0])
    M.extend = synced(lambda a: "extend", saved[1])
    S.apply_rules = synced(lambda a: "pick", saved[2])
    try:
        _, synced_ms = _timed(window)
    finally:
        M.decode_step, M.extend, S.apply_rules = saved
    top = sorted(((ms, n, k) for k, (ms, n) in kernels.items()), reverse=True)[:12]
    return dict(tokens=res.length, rounds=res.rounds, draft_accept_rate=res.draft_accept_rate,
                num_draft_tokens=drafts, wall_ms=wall_ms, ms_per_round=wall_ms / res.rounds,
                launches=launches, launch_calls=launch_calls,
                launch_calls_per_round=launch_calls / res.rounds, traced_ms=traced_ms,
                device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / traced_ms,
                synced_wall_ms=synced_ms,
                parts_ms={k: float(np.mean(v)) if v else None for k, v in parts.items()},
                parts_calls={k: len(v) for k, v in parts.items()},
                top_kernels=[dict(name=k[:120], ms=ms, calls=n) for ms, n, k in top])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="large-v2")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=192)
    ap.add_argument("--quantize", default="fp8")
    ap.add_argument("--num_beams", type=int, default=1)
    ap.add_argument("--prompt_tokens", type=int, default=0)
    ap.add_argument("--assistant", action="store_true",
                    help="profile one speculative window (batch 1) instead")
    ap.add_argument("--num_draft_tokens", type=int, default=5)
    args = ap.parse_args(argv)
    quantize = {"0": 0, "8": 8, "4": 4}.get(args.quantize, args.quantize)
    bits, int8_dots = cross_kv_mode(quantize)

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg, pol = get_config(args.preset), DtypePolicy()
    params = prepare_params(init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16),
                            pol, dev)
    tok = WhisperTokenizer()
    rules = DecodeRules.from_special(tok.special)
    k = args.num_beams
    sot = tok.sot_sequence("zh", "transcribe", timestamps=True)
    prompt = []
    if args.prompt_tokens:
        draw = np.random.RandomState(0).randint(0, tok.special.eot, args.prompt_tokens)
        prompt = [tok.special.sot_prev] + draw.tolist()
    p_len = len(prompt) + len(sot)
    prefix = torch.tensor([prompt + sot] * args.batch, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn((args.batch, N_SAMPLES), generator=gen, device=dev) * 0.1
    max_len = p_len + args.tokens
    if args.assistant:
        spec = speculative_window(params, cfg, pol, audio, sot, rules, args.tokens,
                                  args.num_draft_tokens, dev)
        print(card)
        print(f"speculative window ({args.preset} + its 2-layer student, k "
              f"{args.num_draft_tokens}, {spec['tokens']} tokens): {spec['wall_ms']:.1f} ms, "
              f"{spec['rounds']} rounds ({spec['ms_per_round']:.2f} ms each), accept rate "
              f"{spec['draft_accept_rate']:.4f}, {spec['launch_calls_per_round']:.1f} launch "
              f"calls a round, device idle {100 * spec['idle_share']:.1f}%; synchronised ms per "
              "call: " + ", ".join(f"{k} {v:.3f}" for k, v in spec["parts_ms"].items() if v))
        for row in spec["top_kernels"]:
            print(f"  {row['ms']:9.3f} ms  {row['calls']:6d}  {row['name'][:90]}")
        print(json.dumps({"card": card, "preset": args.preset, "speculative": spec}))
        return

    def decode(enc, budget):
        kw = dict(max_len=p_len + budget, sot_index=len(prompt), quantize_cross_kv=quantize,
                  device=dev)
        if k > 1:
            return beam_decode(params, enc, prefix, cfg, rules, pol, num_beams=k, **kw)
        return greedy_decode(params, enc, prefix, cfg, rules, pol, **kw)

    def run(budget):
        with torch.inference_mode():
            mel, t_mel = _timed(lambda: log_mel(audio, cfg.num_mel_bins))
            enc, t_enc = _timed(lambda: M.encode(params, mel, cfg, pol))
            kv, t_kv = _timed(lambda: M.precompute_cross_kv(params, enc, cfg, pol,
                                                            quantize=bits))
            cache = M.init_cache(params, cfg, args.batch * k, p_len + budget,
                                 dtype=pol.compute_dtype, device=dev)
            _, t_pre = _timed(lambda: M.prefill(params, kv, cache,
                                                prefix.repeat_interleave(k, dim=0), cfg, pol,
                                                aux_index=len(prompt), beams=k,
                                                int8_dots=int8_dots))
            del kv, cache
            res, t_all = _timed(lambda: decode(enc, budget))
        return res, dict(mel_ms=t_mel, encode_ms=t_enc, cross_kv_ms=t_kv,
                         prefill_ms=t_pre, greedy_decode_ms=t_all)

    # warm-up: kernel builds, first launches, allocator, cuBLAS handles
    _, warmup_ms = _timed(lambda: run(8))
    res, stages = run(args.tokens)
    stages["warmup_ms"] = warmup_ms
    steps = int(max_len - p_len)
    loop_ms = stages["greedy_decode_ms"] - stages["cross_kv_ms"] - stages["prefill_ms"]
    stages["decode_loop_ms"] = loop_ms
    stages["step_ms"] = loop_ms / steps
    batch_ms = stages["mel_ms"] + stages["encode_ms"] + stages["greedy_decode_ms"]
    stages["audio_s_per_s"] = args.batch * 30.0 / (batch_ms / 1e3)
    stages.update(vad_stage(dev))

    # trace a window of decode steps
    with torch.inference_mode():
        enc = M.encode(params, log_mel(audio, cfg.num_mel_bins), cfg, pol)
        kv = M.precompute_cross_kv(params, enc, cfg, pol, quantize=bits)
        cache = M.init_cache(params, cfg, args.batch * k, max_len, dtype=pol.compute_dtype,
                             device=dev)
        M.prefill(params, kv, cache, prefix.repeat_interleave(k, dim=0), cfg, pol, beams=k,
                  int8_dots=int8_dots)
        token = prefix[:, -1].repeat_interleave(k)
        for i in range(p_len, p_len + 2):
            M.decode_step(params, kv, cache, token, i, cfg, pol, beams=k, int8_dots=int8_dots)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(p_len + 2, p_len + 2 + STEPS_TRACED):
                M.decode_step(params, kv, cache, token, i, cfg, pol, beams=k,
                              int8_dots=int8_dots)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        loop = loop_window(lambda n: decode(enc, n), min(args.tokens, 24))
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
    print(f"decode loop ({'beam ' + str(k) if k > 1 else 'greedy'}, positions "
          f"{min(args.tokens, 24)}-{min(args.tokens, 24) + STEPS_TRACED - 1} past the prefix): "
          f"{loop['step_ms']:.3f} ms a step untraced, device busy {loop['busy_ms']:.3f} ms "
          f"(idle {100 * loop['idle_share']:.1f}%), {loop['launch_calls']:.1f} launch calls; "
          + ", ".join(f"{n} {ms:.4f} ms" for n, ms in loop["parts_ms"].items()))
    for row in loop["kernels"]:
        print(f"  {row['ms_per_step']:9.4f} ms/step  {row['calls_per_step']:7.1f}/step  "
              f"{row['name'][:90]}")
    print(json.dumps({"card": card, "preset": args.preset, "batch": args.batch,
                      "num_beams": k, "prompt_tokens": args.prompt_tokens, "loop": loop,
                      "tokens": args.tokens, "quantize": args.quantize, "stages": stages,
                      "window_steps": STEPS_TRACED, "window_ms": window_ms,
                      "device_busy_ms": busy_ms,
                      "top_kernels": [dict(name=n[:120], ms_per_step=ms / STEPS_TRACED,
                                           calls_per_step=c / STEPS_TRACED)
                                      for ms, c, n in rows[:20]]}))


if __name__ == "__main__":
    main()
