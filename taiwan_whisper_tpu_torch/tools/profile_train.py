"""Where the time of one train step goes, on the card.

    python -m taiwan_whisper_tpu_torch.tools.profile_train [--preset large-v2]
        [--batch 32] [--labels 448] [--trainable]

Random weights from a seed as fp32 masters (teacher = the preset, student =
its 2-decoder-layer copy), one batch of 30 s of random audio and random
labels at the driver's padded length. Default: the ``cli distill`` step
(frozen encoder, ce 0.8 + kl 1.0 at T 2); ``--trainable``: the ``cli
finetune`` step (CE only, the encoder trains, each layer checkpointed).

Times each stage of the step with the host clock around synchronised work
(mel, encoder, teacher decoder, student forward, loss, backward, clip and
AdamW), then whole steps of ``make_train_step``, then traces one step with
torch.profiler and prints device time by kernel and the device's busy
share. Prints one JSON object as its last line; writes the trace under
``chiprun_out/``.
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
from ..models import whisper as M
from ..models.config import DtypePolicy, get_config, resolve_device
from ..models.params import init_params, init_student_from_teacher, named_leaves
from ..ops.mel_kernel import log_mel
from ..train.distill import (DistillConfig, global_norm, kl_divergence, make_train_step,
                             masked_cross_entropy, trainable_paths)
from ..train.state import OptimConfig, make_optimizer, trainable_mask

STEPS_TIMED = 3


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
    ap.add_argument("--labels", type=int, default=448, help="padded label length")
    ap.add_argument("--trainable", action="store_true",
                    help="the finetune step: CE only, the encoder trains")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    tcfg = get_config(args.preset)
    scfg = tcfg.with_decoder_layers(2)
    teacher = init_params(tcfg, seed=0, device=dev)
    student = init_student_from_teacher(teacher, tcfg, 2)
    teacher = {"decoder": teacher["decoder"]}
    dcfg = (DistillConfig(ce_weight=1.0, kl_weight=0.0, freeze_encoder=False)
            if args.trainable else DistillConfig())
    pol = DtypePolicy()
    opt = make_optimizer(OptimConfig(learning_rate=1e-4, warmup_steps=0),
                         mask=trainable_mask(student, dcfg.freeze_encoder))
    state = opt.init(student)

    rng = np.random.RandomState(0)
    b, u = args.batch, args.labels - 1
    audio = torch.from_numpy((rng.randn(b, N_SAMPLES) * 0.1).astype(np.float32)).to(dev)
    dec_in = torch.from_numpy(rng.randint(0, 50000, (b, u)).astype(np.int32)).to(dev)
    labels = rng.randint(0, 50000, (b, u)).astype(np.int32)
    labels[:, :3] = -100
    labels = torch.from_numpy(labels).to(dev)

    def staged():
        """One train step taken apart, each stage synchronised."""
        t = {}
        mel, t["mel_ms"] = _timed(lambda: log_mel(audio, scfg.num_mel_bins))
        leaves = dict(named_leaves(student))
        paths = trainable_paths(student, dcfg.freeze_encoder)
        for p in paths:
            leaves[p].requires_grad_(True)
        if dcfg.freeze_encoder:
            with torch.no_grad():
                enc, t["encoder_ms"] = _timed(
                    lambda: M.encode(student, mel, scfg, pol, remat=False))
        else:
            enc, t["encoder_fwd_ms"] = _timed(lambda: M.encode(student, mel, scfg, pol))
        t_logits = None
        if dcfg.kl_weight > 0:
            with torch.no_grad():
                t_logits, t["teacher_decoder_ms"] = _timed(lambda: M.decode_train(
                    teacher, enc.detach(), dec_in, tcfg, pol, remat=False))
        s_logits, t["student_fwd_ms"] = _timed(lambda: M.decode_train(
            student, enc, dec_in, scfg, pol, remat=False))

        def loss_fn():
            ce_sum, n = masked_cross_entropy(s_logits, labels)
            loss = dcfg.ce_weight * ce_sum / n.clamp(min=1)
            if t_logits is not None:
                kl_sum, _ = kl_divergence(t_logits, s_logits, labels, dcfg.temperature)
                loss = loss + dcfg.kl_weight * kl_sum / n.clamp(min=1)
            return loss

        loss, t["loss_ms"] = _timed(loss_fn)
        got, t["backward_ms"] = _timed(lambda: torch.autograd.grad(
            loss, [leaves[p] for p in paths], allow_unused=True))
        del s_logits, t_logits, loss

        def update():
            grads = dict(zip(paths, got))
            scale = torch.clamp(1.0 / (global_norm(grads) + 1e-6), max=1.0)
            grads = {p: None if g is None else g * scale for p, g in grads.items()}
            updates, _ = opt.update(grads, state, leaves)
            with torch.no_grad():
                for p, up in updates.items():
                    if up is not None:
                        leaves[p].add_(up)

        _, t["optimizer_ms"] = _timed(update)
        t["sum_ms"] = sum(t.values())
        return t

    staged()  # warm-up: kernel builds, allocator, cuBLAS plans
    torch.cuda.reset_peak_memory_stats()
    stages = staged()
    step = make_train_step(scfg, tcfg, dcfg, opt, pol)
    batch = {"mel": None, "decoder_input_ids": dec_in, "labels": labels}

    def one_step():
        nonlocal student, state
        batch["mel"] = log_mel(audio, scfg.num_mel_bins)
        student, state, metrics = step(student, state, teacher, batch)
        return float(metrics["loss"])

    one_step()
    _, total = _timed(lambda: [one_step() for _ in range(STEPS_TIMED)])
    step_ms = total / STEPS_TIMED
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, window_ms = _timed(one_step)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "finetune" if args.trainable else "distill"
    prof.export_chrome_trace(os.path.join("chiprun_out", f"train_step_trace_{name}.json"))
    print(card)
    print(f"stages (ms, {name}, batch {b}, {u} decoder positions): " + json.dumps(stages))
    print(f"train step: {step_ms:.1f} ms = {b / step_ms * 1e3:.2f} samples/s over "
          f"{STEPS_TIMED} steps; peak {peak / 1e9:.2f} GB; traced step {window_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / window_ms:.1f}%)")
    for ms, n, key in rows[:25]:
        print(f"  {ms:9.3f} ms  {n:6d}x  {key[:100]}")
    print(json.dumps({"card": card, "preset": args.preset, "step": name, "batch": b,
                      "decoder_positions": u, "stages": stages, "step_ms": step_ms,
                      "samples_per_s": b / step_ms * 1e3, "peak_bytes": peak,
                      "traced_step_ms": window_ms, "device_busy_ms": busy_ms,
                      "top_kernels": [dict(name=k[:120], ms=ms, calls=c)
                                      for ms, c, k in rows[:25]]}))


if __name__ == "__main__":
    main()
