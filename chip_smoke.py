"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py            # every phase, as a release check runs it
    python3 chip_smoke.py kernels    # only the named phases (kernels, label, agree)

Phases, each raising on failure:

1. build   — compiles every CUDA kernel of taiwan_whisper_tpu_torch from
   the checkout's csrc/ (one nvcc per source, all started together).
2. kernels — calls each kernel's wrapper, in every variant a driven path
   launches, and holds it against its plain PyTorch version on the same
   inputs, with the tolerance stated beside it: bf16 at the labelling
   path's shapes (large-v2, batch 32), fp32 at the agree phase's (base,
   batch 4). Times kernel, plain version and, where one exists, the one
   PyTorch call that computes the same function (CUDA events, median, L2
   flushed before every launch).
3. label   — the port's ``cli label`` at full large-v2 width with random
   bf16 weights from a seed: 8 synthetic WAVs of 170 s (64 chunks, two
   batches of 32), fp8 cross-KV, VAD off, 192-token budget. Every launch
   counter is zeroed just before and read just after, and must equal the
   count this run implies.
4. agree   — the base preset at batch 4, fp32 policy with TF32 off, greedy
   for 32 tokens on the card and on the CPU plain path; token agreement
   must be at least 0.98 of positions, and the launch counters, zeroed
   just before the card's run, must equal the count that run implies.

Prints the card's name and power limit, a ``kernels`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, flop/s by operand type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

LARGE_V2_BATCH = 32
LABEL_FILES, LABEL_SECONDS, MAX_DECODE_TOKENS = 8, 170.0, 192
AGREE_BATCH, AGREE_TOKENS = 4, 32


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


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

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


def phase_kernels(torch, entries: dict, checks: list):
    """Every kernel variant a driven path launches, held against its plain
    version: the label path's (large-v2, batch 32, bf16, fp8 cross-KV) and
    the agree phase's (base, batch 4, fp32 policy)."""
    import torch.nn.functional as F

    from taiwan_whisper_tpu_torch.audio import mel as A
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.ops import attention as EA
    from taiwan_whisper_tpu_torch.ops import decode_attention as DA
    from taiwan_whisper_tpu_torch.ops import mel_kernel as MK

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
        checks.append(dict(check=key, ref_max_abs=ref_max, **{
            k: row[k] for k in ("max_abs_err", "tolerance", "ms", "plain_ms")}))
        log(f"[kernel] {key}: err {err:.3g} (tol {tol:g}, max |plain| {ref_max:.3g}) "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"library {library_ms}")
        return row

    # 1. mel: 32 x 30 s of audio. Tolerance 1e-4 on the normalised log-mel:
    # fp32 throughout, only the summation order differs. The agree phase
    # runs the same (fp32-only) kernel at batch 4.
    audio = torch.randn((B, A.N_SAMPLES), generator=g, device=dev) * 0.1
    got = MK.log_mel(audio)
    ref = A.log_mel(audio)
    torch.cuda.synchronize()
    n_frames, m = A.N_FRAMES, 80
    flops = 2 * 2 * B * n_frames * A.N_FFT * A.N_FREQS + 2 * B * n_frames * A.N_FREQS * m
    entries["mel"] = record(
        "mel", "log_mel", "taiwan_whisper_tpu_torch/csrc/mel.cu",
        "taiwan_whisper_tpu/ops/mel_kernel.py:60", got, ref, 1e-4,
        time_ms(lambda: MK.log10_mel_spectrum(audio), torch, flush=flush),
        time_ms(lambda: A.log10_mel_spectrum(audio), torch, flush=flush),
        bound_ms(4 * (B * A.N_SAMPLES + B * n_frames * m), flops, "fp32"), None)
    del audio, got, ref

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
    q4, v4 = (q.float() * 4).to(bf16), (v.float() / 4).to(bf16)  # exact in bf16
    record("encoder_attention[bf16,peaked]", "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q4, k, v4), EA.attention_plain(q4, k, v4), 2e-2,
           time_ms(lambda: EA.encoder_attention(q4, k, v4), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q4, k, v4), torch, iters=3, flush=flush),
           enc_bound, None)
    del q, k, v, qt, kt, vt, q4, v4
    q, k, v = (torch.randn((AB, T, AH, D), generator=g, device=dev) for _ in range(3))
    record("encoder_attention[fp32,agree]", "encoder_attention", enc_src, enc_rep,
           EA.encoder_attention(q, k, v), EA.attention_plain(q, k, v), 1e-5,
           time_ms(lambda: EA.encoder_attention(q, k, v), torch, flush=flush),
           time_ms(lambda: EA.attention_plain(q, k, v), torch, flush=flush),
           bound_ms(4 * AB * T * AH * D * 4, 4 * AB * AH * T * T * D, "fp32"), None)
    del q, k, v

    # 3. cross attention over one layer's time-minor K/V [B, H, 64, 1500],
    # 1 query row (decode step) and 3 (prefill): bf16 q with bf16/int8/fp8
    # storage at the label path's shapes, fp32 q with fp32/int8/fp8 storage
    # at the agree phase's. q is scaled so the scores have unit spread, as
    # in the model; the error is read after the V scale the model applies
    # next (dequantized output, O(1)). Tolerance 1e-3 for bf16 q: fp32
    # output from identical inputs; the probabilities are rounded to bf16 on
    # both sides, and a fp32 summation-order difference can move one across
    # a bf16 rounding boundary. Tolerance 1e-5 for fp32 q: nothing is
    # rounded below fp32, only the summation order differs.
    def cross_cases(b, h, q_dtype, stores, tol, entry):
        base = torch.randn((b, h, D, T), generator=g, device=dev)
        for store, (kq, vq, q_scale, v_scale) in stores(base).items():
            for rows in (1, 3):
                qs = (torch.randn((b, rows, h, D), generator=g, device=dev)
                      * q_scale).to(q_dtype)
                lib = None
                if kq.dtype == q_dtype:
                    qh, kh, vh = qs.transpose(1, 2), kq.transpose(-1, -2), vq.transpose(-1, -2)
                    lib = time_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, scale=1.0), torch, flush=flush)
                row = record(
                    f"cross_attention[{str(q_dtype)[6:]} q,{store},rows={rows}]",
                    "cross_decode_attention",
                    "taiwan_whisper_tpu_torch/csrc/decode_attention.cu",
                    "taiwan_whisper_tpu/ops/decode_attention.py:69",
                    DA.cross_attention(qs, kq, vq) * v_scale,
                    DA.cross_attention_plain(qs, kq, vq) * v_scale, tol,
                    time_ms(lambda: DA.cross_attention(qs, kq, vq), torch, iters=20,
                            flush=flush),
                    time_ms(lambda: DA.cross_attention_plain(qs, kq, vq), torch, flush=flush),
                    bound_ms(2 * kq.numel() * kq.element_size() + qs.numel() * qs.element_size()
                             + b * rows * h * D * 4, 4 * b * h * rows * T * D,
                             "bf16" if q_dtype == bf16 else "fp32"), lib)
                if (store, rows) == entry:
                    entries["cross_decode_attention"] = row

    def quantized(base):
        return {"int8": (torch.randint(-127, 128, base.shape, generator=g, device=dev,
                                       dtype=torch.int8),) * 2 + (0.002, 1 / 127),
                "fp8": ((base * 50).to(torch.float8_e4m3fn),
                        (base * 25).to(torch.float8_e4m3fn), 0.0025, 1 / 25)}

    cross_cases(B, H, bf16, lambda base: {
        "bf16": (base.to(bf16), (base * 0.5).to(bf16), 0.125, 1.0), **quantized(base)},
        1e-3, ("fp8", 1))  # fp8 with 1 row is what each label decode step runs
    cross_cases(AB, AH, f32, lambda base: {
        "fp32": (base, base * 0.5, 0.125, 1.0), **quantized(base)}, 1e-5, None)

    # 4. self attention over the cache [B, H, 64, S] at the last step
    # (index S - 1): bf16 at the label path's shapes with no valid_from
    # (what the label path passes: the kernel's null-pointer branch) and
    # with a mixed valid_from; fp32 at the agree phase's shapes with no
    # valid_from. Tolerances 1e-3 (bf16) and 1e-5 (fp32) as for cross.
    def self_case(b, h, s, dtype, vf, tol):
        index = s - 1
        ck, cv = (torch.randn((b, h, D, s), generator=g, device=dev).to(dtype)
                  for _ in range(2))
        qs, k_t, v_t = (torch.randn((b, h, D), generator=g, device=dev).to(dtype)
                        for _ in range(3))
        qs = qs * 0.125
        valid = b * index if vf is None else int((index - vf.clamp(max=index)).sum())
        size = torch.tensor([], dtype=dtype).element_size()
        key = f"self_attention[{str(dtype)[6:]},valid_from={'none' if vf is None else 'mixed'}]"
        return record(
            key, "self_decode_attention", "taiwan_whisper_tpu_torch/csrc/decode_attention.cu",
            "taiwan_whisper_tpu/ops/decode_attention.py:132",
            DA.self_attention(qs, ck, cv, k_t, v_t, index, vf),
            DA.self_attention_plain(qs, ck, cv, k_t, v_t, index, vf), tol,
            time_ms(lambda: DA.self_attention(qs, ck, cv, k_t, v_t, index, vf), torch,
                    iters=20, flush=flush),
            time_ms(lambda: DA.self_attention_plain(qs, ck, cv, k_t, v_t, index, vf), torch,
                    flush=flush),
            bound_ms(2 * valid * h * D * size + 3 * b * h * D * size
                     + (0 if vf is None else b * 4) + b * h * D * 4,
                     4 * valid * h * D, "bf16" if dtype == bf16 else "fp32"), None)

    S = 3 + MAX_DECODE_TOKENS
    entries["self_decode_attention"] = self_case(B, H, S, bf16, None, 1e-3)
    self_case(B, H, S, bf16, torch.randint(0, 3, (B,), generator=g, device=dev,
                                           dtype=torch.int32), 1e-3)
    self_case(AB, AH, AS, f32, None, 1e-5)


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


def phase_label(torch, entries: dict, results: dict):
    from taiwan_whisper_tpu_torch import cli, get_config
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.models.io import save_hf_checkpoint
    from taiwan_whisper_tpu_torch.models.params import init_params, num_params
    from taiwan_whisper_tpu_torch.ops import attention, decode_attention, mel_kernel

    cfg = get_config("large-v2")
    counters = {"mel": mel_kernel.log10_mel_spectrum,
                "encoder_attention": attention.encoder_attention,
                "cross_decode_attention": decode_attention.cross_attention,
                "self_decode_attention": decode_attention.self_attention}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        model_dir = os.path.join(tmp, "model")
        save_hf_checkpoint(model_dir, params, cfg)
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        names = _synth_wavs(audio_dir, LABEL_FILES, LABEL_SECONDS, seed=0)
        manifest = os.path.join(tmp, "manifest.tsv")
        write_manifest(manifest, Manifest(root=audio_dir, paths=names))
        log(f"[label] large-v2 bf16 checkpoint ({num_params(params) / 1e9:.3f} B "
            f"params) + {LABEL_FILES} x {LABEL_SECONDS:.0f} s WAVs written in "
            f"{time.perf_counter() - t0:.1f} s")

        del params
        out_dir = os.path.join(tmp, "labels")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = cli.main([
            "label", "--manifest", manifest, "--model", model_dir, "--output_dir", out_dir,
            "--batch_size", str(LARGE_V2_BATCH), "--quantize_kv", "fp8", "--language", "zh",
            "--vad_mode", "off", "--max_decode_tokens", str(MAX_DECODE_TOKENS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        csvs = sorted(n for n in os.listdir(out_dir) if n.endswith(".csv"))
        rows = 0
        for n in csvs:
            with open(os.path.join(out_dir, n), encoding="utf-8") as f:
                rows += sum(1 for _ in f) - 1
    batches = stats["batches"]
    expected = {"mel": batches, "encoder_attention": batches * cfg.encoder_layers,
                "cross_decode_attention": batches * cfg.decoder_layers * (1 + MAX_DECODE_TOKENS),
                "self_decode_attention": batches * cfg.decoder_layers * MAX_DECODE_TOKENS}
    rate = stats["audio_seconds"] / stats["wall_seconds"]
    log(f"[label] {stats['files']} files, {stats['chunks']} chunks, {batches} batches: "
        f"{rate:.2f} audio-s/s (label_files wall {stats['wall_seconds']:.2f} s, cli wall "
        f"incl. checkpoint load {wall:.2f} s, decode {stats['decode_s']:.2f} s); "
        f"{len(csvs)} CSVs, {rows} segment rows")
    log(f"[label] launches {json.dumps(launches)} expected {json.dumps(expected)}")
    if stats["files"] != LABEL_FILES or len(csvs) != LABEL_FILES or batches != 2:
        raise AssertionError(f"label run incomplete: {stats}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    for k, n in launches.items():
        entries.setdefault(k, {})["launches"] = n
    results["label"] = dict(audio_s_per_s=rate, wall_seconds=stats["wall_seconds"],
                            cli_wall_seconds=wall, chunks=stats["chunks"], batches=batches,
                            csvs=len(csvs), segment_rows=rows)


def phase_agree(torch, results: dict):
    from taiwan_whisper_tpu_torch import DtypePolicy, get_config
    from taiwan_whisper_tpu_torch.audio.mel import N_SAMPLES
    from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
    from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
    from taiwan_whisper_tpu_torch.models import whisper as M
    from taiwan_whisper_tpu_torch.models.config import resolve_device
    from taiwan_whisper_tpu_torch.models.params import init_params, prepare_params
    from taiwan_whisper_tpu_torch.ops import attention, decode_attention, mel_kernel
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
    counters = {"mel": mel_kernel.log10_mel_spectrum,
                "encoder_attention": attention.encoder_attention,
                "cross_decode_attention": decode_attention.cross_attention,
                "self_decode_attention": decode_attention.self_attention}
    out = {}
    for dev in ("cuda", "cpu"):
        params = prepare_params(weights, pol, dev)
        if dev == "cuda":
            for fn in counters.values():
                fn.launches = 0
        with torch.inference_mode():
            enc = M.encode(params, mel_kernel.log_mel(audio.to(dev)), cfg, pol)
        res = greedy_decode(params, enc, prefix, cfg, rules, pol,
                            max_len=len(sot) + AGREE_TOKENS, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
        out[dev] = res.tokens[:, len(sot):].cpu().numpy()
    # Steps the card's loop ran: every row has emitted eot after step
    # `done`, and the loop polls for that every 8 steps (decode/greedy.py).
    eot_at = [np.flatnonzero(row == rules.eot) for row in out["cuda"]]
    done = max((e[0] if len(e) else AGREE_TOKENS) for e in eot_at)
    steps = min(AGREE_TOKENS, -(-(done + 1) // 8) * 8)
    expected = {"mel": 1, "encoder_attention": cfg.encoder_layers,
                "cross_decode_attention": cfg.decoder_layers * (1 + steps),
                "self_decode_attention": cfg.decoder_layers * steps}
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
    phases = argv or ["kernels", "label", "agree"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase_build()
    entries, checks, results = {}, [], {}
    if "kernels" in phases:
        phase_kernels(torch, entries, checks)
        log("checks " + json.dumps({"checks": checks}))
    if "label" in phases:
        phase_label(torch, entries, results)
    if "agree" in phases:
        phase_agree(torch, results)
    log("results " + json.dumps(results))
    log(json.dumps({"kernels": [dict(name=r["name"], route=r["route"], source=r["source"],
                                     replaces=r["replaces"], launches=r.get("launches"),
                                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                     bound_by=r["bound_by"], library_ms=r["library_ms"])
                                for r in entries.values() if "ms" in r]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
