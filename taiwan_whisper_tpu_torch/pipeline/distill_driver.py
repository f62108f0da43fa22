"""Stage 3 driver: the knowledge-distillation and fine-tuning loop (port of
taiwan_whisper_tpu/pipeline/distill_driver.py).

Teacher and student setup (language-embedding mix, maximally-spaced
student init, frozen or trainable encoder), streaming manifest batches on a
prefetch thread, the log-mel on the device through the mel kernel, the
train step, loss-only eval with best-checkpoint tracking, the generation
eval (``gen_eval_batches``: greedy decoding of eval batches, MER against
their labels, prediction tables), checkpoint save/rotate/resume (skipping
consumed batches), SIGTERM/SIGINT checkpointing, and the HF export of the
student at every save; metrics to ``metrics.jsonl`` and, with
``use_wandb``, wandb.

Weights are fp32 masters on the device whatever the checkpoint stores;
compute runs in the policy's dtype. Only the teacher's decoder goes to the
device (the student's encoder serves both), and a CE-only run loads no
teacher.

In a multi-process run (``parallel.init_distributed``) the ranks form the
``(data, model)`` grid of ``parallel.mesh.make_mesh(model_parallel)``; a
world that ``model_parallel`` does not divide raises before any model
loads. ``batch_size`` is the global batch: every
rank builds the same batch stream from the same seed, each model group
trains on its data rank's contiguous slice of rows, and the step reduces
the token count, gradients and metrics over the data group
(``train/distill.py``). Under tensor parallel (``model_parallel`` > 1)
each rank of a model group holds its shards of the student and the
teacher's decoder (``parallel/specs.py``), cut after load. Rank 0 writes
the metrics, the checkpoints and the HF export, both of full tensors
gathered over its model group; the ranks of model group 0 run the
generation eval together (its collectives need every shard), rank 0
alone logs its tables and the other ranks wait at a named barrier. A
signal on any rank stops every rank at the same step.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..audio.manifest import read_manifest
from ..decode.greedy import greedy_decode
from ..decode.rules import DecodeRules
from ..models import whisper as M
from ..models.config import DtypePolicy, resolve_device
from ..models.io import load_model, save_hf_checkpoint
from ..models.params import (init_student_from_teacher, map_params, mix_language_embeddings,
                              prepare_params)
from ..ops import mel_kernel
from ..parallel import mesh, specs
from ..text.metrics import MixErrorRate
from ..text.normalizer import BasicTextNormalizer
from ..text.tokenizer import WhisperTokenizer
from ..train.distill import DistillConfig, make_eval_step, make_train_step
from ..train.state import CheckpointManager, OptimConfig, make_optimizer, trainable_mask
from ..utils.logging import MetricsLogger
from ..utils.prefetch import prefetch
from ..utils.profiling import span
from .dataset import TrainPrepConfig, train_batches


@dataclasses.dataclass
class DistillRunConfig:
    max_steps: int = 120_000
    batch_size: int = 32  # the global batch: each process of a run trains on its slice
    model_parallel: int = 1
    save_steps: int = 1000
    eval_steps: int = 1000
    logging_steps: int = 25
    save_total_limit: Optional[int] = 3
    seed: int = 42
    mix_lang_embeddings: bool = True  # zh <- (zh+en)/2, the K2D trick
    resume: bool = True
    use_wandb: bool = False
    gen_eval_batches: int = 0  # >0: greedy-decode N eval batches -> MER
    gen_eval_max_tokens: int = 128
    gen_eval_table_rows: int = 32
    num_workers: int = 4  # audio-decode threads (0 = inline)


def _make_mesh(run_cfg: DistillRunConfig):
    """Lay the run out as its ``(data, model)`` grid; raises when the
    world or the global batch does not divide."""
    mesh.make_mesh(model=run_cfg.model_parallel)
    if run_cfg.batch_size % mesh.data_size():
        raise ValueError(f"--batch_size {run_cfg.batch_size} (the global batch) does not "
                         f"divide over {mesh.data_size()} data-parallel groups")


def _masters(params, device, config=None):
    """fp32 copies on ``device`` of every leaf of this rank's shard of
    ``params`` (the training masters); ``config`` checks the split."""
    if mesh.model_size() > 1:
        params = specs.shard_params(params, mesh.model_rank(), mesh.model_size(), config)
    return map_params(lambda _, t: t.to(device=device, dtype=torch.float32), params)


def run_distillation(train_manifest_path: str, teacher_dir: str, output_dir: str, *,
                     student_dir: Optional[str] = None, student_decoder_layers: int = 2,
                     student_encoder_layers: Optional[int] = None,
                     run_cfg: DistillRunConfig = DistillRunConfig(),
                     dcfg: DistillConfig = DistillConfig(),
                     opt_cfg: Optional[OptimConfig] = None,
                     prep_cfg: TrainPrepConfig = TrainPrepConfig(),
                     tokenizer_dir: Optional[str] = None,
                     eval_manifest_path: Optional[str] = None,
                     policy: DtypePolicy = DtypePolicy(), device=None) -> Dict[str, float]:
    """Train a student for ``run_cfg.max_steps`` steps; returns the metrics
    of the last logged step."""
    _make_mesh(run_cfg)
    dev = resolve_device(device)
    tok = (WhisperTokenizer.from_pretrained_dir(tokenizer_dir) if tokenizer_dir
           else WhisperTokenizer())
    need_teacher = dcfg.kl_weight > 0.0 or dcfg.mse_weight > 0.0

    teacher = None
    if need_teacher or not student_dir:
        teacher, teacher_cfg = load_model(teacher_dir)
        teacher = map_params(lambda _, t: t.float(), teacher)
        if run_cfg.mix_lang_embeddings:
            zh, en = tok.special.language_id("zh"), tok.special.language_id("en")
            teacher = mix_language_embeddings(teacher, zh, [zh, en])
    if student_dir:
        student, student_cfg = load_model(student_dir)
    else:
        student_cfg = teacher_cfg.with_decoder_layers(student_decoder_layers)
        if student_encoder_layers is not None:
            student_cfg = student_cfg.with_encoder_layers(student_encoder_layers)
        student = init_student_from_teacher(teacher, teacher_cfg, student_decoder_layers,
                                            encoder_layers=student_encoder_layers)
    if not need_teacher:
        teacher, teacher_cfg = None, student_cfg
    student = _masters(student, dev, student_cfg)
    # the student's encoder serves both decoders: only the teacher's
    # decoder goes to the device
    if teacher is not None:
        teacher = {"decoder": _masters(teacher["decoder"], dev, teacher_cfg)}

    opt_cfg = opt_cfg or OptimConfig(total_steps=run_cfg.max_steps)
    optimizer = make_optimizer(opt_cfg, mask=trainable_mask(student, dcfg.freeze_encoder))
    # pad/trim audio to the student's context and labels to its decoder length
    prep_cfg = dataclasses.replace(
        prep_cfg, chunk_samples=student_cfg.max_source_positions * 320,
        max_label_length=min(prep_cfg.max_label_length, student_cfg.max_target_positions))
    train_step = make_train_step(student_cfg, teacher_cfg, dcfg, optimizer, policy)
    eval_step = make_eval_step(student_cfg, teacher_cfg, dcfg, policy)
    per_rank = run_cfg.batch_size // mesh.data_size()
    rows = slice(mesh.data_rank() * per_rank, (mesh.data_rank() + 1) * per_rank)

    manifest = read_manifest(train_manifest_path)
    if not manifest.paths:
        # an empty manifest would make the epoch stream spin forever
        raise ValueError(f"empty train manifest: {train_manifest_path}")
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"), run_cfg.save_total_limit)
    logger = MetricsLogger(output_dir, use_wandb=run_cfg.use_wandb)

    opt_state = optimizer.init(student)
    start_step = 0
    if run_cfg.resume:
        restored, step0 = ckpt.restore(map_location=dev)
        if restored is not None:
            student, opt_state, start_step = restored["params"], restored["opt_state"], step0
            print(f"[distill] resumed from step {start_step}", flush=True)

    def to_device(batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch on the device, with their
        log-mel (span ``train.upload``)."""
        with span("train.upload"):
            audio = torch.from_numpy(batch["audio"][rows]).to(dev)
            return {"mel": mel_kernel.log_mel(audio, student_cfg.num_mel_bins),
                    "decoder_input_ids":
                        torch.from_numpy(batch["decoder_input_ids"][rows]).to(dev),
                    "labels": torch.from_numpy(batch["labels"][rows]).to(dev)}

    # held-out eval: loss-only over a fixed batch set, tracking the best
    # checkpoint
    eval_batches = []
    if eval_manifest_path:
        eval_prep = dataclasses.replace(prep_cfg, timestamp_probability=1.0,
                                        condition_on_prev_probability=0.0)
        for eb in train_batches(read_manifest(eval_manifest_path), tok, eval_prep,
                                run_cfg.batch_size, seed=0, shuffle=False):
            eval_batches.append(eb)
            if len(eval_batches) >= 8:
                break
    best_eval_loss = float("inf")

    def run_eval(step):
        nonlocal best_eval_loss
        if not eval_batches:
            return
        totals: Dict[str, float] = {}
        for eb in eval_batches:
            for k, v in eval_step(student, teacher, to_device(eb)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
        avg = {k: v / len(eval_batches) for k, v in totals.items()}
        logger.log(avg, step, prefix="eval")
        if run_cfg.gen_eval_batches > 0 and mesh.data_rank() == 0:
            mer, table = generation_eval(
                student, student_cfg, tok, eval_batches[:run_cfg.gen_eval_batches],
                prep_cfg.language, prep_cfg.task, run_cfg.gen_eval_max_tokens, policy, dev)
            if mesh.is_main():
                logger.log({"gen_mer": mer}, step, prefix="eval")
                cols = ("pred", "label", "norm_pred", "norm_label")
                cap = run_cfg.gen_eval_table_rows
                logger.log_table("predictions", cols, table[:cap], step)
                wrong = [r for r in table if r[2] != r[3]]
                logger.log_table("incorrect_predictions", cols, wrong[:cap], step)
        if run_cfg.gen_eval_batches > 0 and mesh.model_size() > 1:
            mesh.barrier(f"gen_eval_done_{step}")
        if avg["loss"] < best_eval_loss:
            best_eval_loss = avg["loss"]
            ckpt.save(step, {"params": student, "opt_state": opt_state}, keep=True)
            print(f"[distill] new best eval loss {best_eval_loss:.4f} @ step {step} (kept)",
                  flush=True)

    def batch_stream() -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            yield from train_batches(manifest, tok, prep_cfg, run_cfg.batch_size,
                                     seed=run_cfg.seed + epoch, mel_fn=None,
                                     num_workers=run_cfg.num_workers)
            epoch += 1

    # SIGTERM/SIGINT set a flag; the loop checkpoints and stops at the next
    # step boundary, every rank at the same one (a rank that left alone
    # would leave the others waiting in the step's all-reduce)
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
        print(f"[distill] signal {signum}: checkpointing at next step", flush=True)

    old_handlers = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        step, last_logged, t_last = start_step, start_step, time.time()
        final_metrics: Dict[str, float] = {}
        stream = batch_stream()
        for _ in range(start_step):  # skip the batches a resumed run consumed
            next(stream, None)
        for batch in prefetch(stream, buffer_size=2):
            if step >= run_cfg.max_steps:
                break
            if mesh.any_rank(preempted["flag"]):
                ckpt.save(step, {"params": student, "opt_state": opt_state})
                print(f"[distill] preempted; saved checkpoint-{step}", flush=True)
                break
            student, opt_state, metrics = train_step(student, opt_state, teacher,
                                                     to_device(batch))
            step += 1
            if step % run_cfg.logging_steps == 0 or step == run_cfg.max_steps:
                host = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.time()
                host["steps_per_s"] = (step - last_logged) / max(now - t_last, 1e-6)
                t_last, last_logged = now, step
                logger.log(host, step)
                final_metrics = host
            if step % run_cfg.eval_steps == 0 or step == run_cfg.max_steps:
                run_eval(step)
            if step % run_cfg.save_steps == 0 or step == run_cfg.max_steps:
                saved = ckpt.save(step, {"params": student, "opt_state": opt_state})
                if mesh.is_main():
                    save_hf_checkpoint(os.path.join(output_dir, "hf_export"),
                                       saved["params"], student_cfg)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        logger.close()
    return final_metrics


def generation_eval(params, config, tok: WhisperTokenizer, batches, language: str, task: str,
                    max_tokens: int, policy: DtypePolicy, device):
    """Greedy-decode the audio of ``batches`` (timestamps on, at most
    ``max_tokens`` after the sot sequence) and score the normalized texts
    against the batches' label texts: returns (MER, a row (pred, label,
    norm_pred, norm_label) per sample)."""
    rules = DecodeRules.from_special(tok.special, timestamps=True)
    sot = tok.sot_sequence(language, task)
    max_len = min(len(sot) + max_tokens, config.max_target_positions)
    params = prepare_params(params, policy, device)
    norm = BasicTextNormalizer()
    table = []
    for eb in batches:
        audio = torch.from_numpy(eb["audio"]).to(device)
        with torch.inference_mode():
            enc = M.encode(params, mel_kernel.log_mel(audio, config.num_mel_bins), config,
                           policy)
        prefix = torch.tensor([sot] * audio.shape[0], dtype=torch.int32, device=device)
        res = greedy_decode(params, enc, prefix, config, rules, policy, max_len=max_len,
                            device=device)
        tokens, lengths = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
        for j in range(tokens.shape[0]):
            pred = tok.decode(tokens[j][len(sot):len(sot) + int(lengths[j])].tolist(),
                              skip_special_tokens=True)
            label = tok.decode([int(t) for t in eb["labels"][j] if 0 <= t < tok.special.eot],
                               skip_special_tokens=True)
            table.append((pred, label, norm(pred), norm(label)))
    mer = MixErrorRate().compute([r[2] for r in table], [r[3] for r in table])
    return float(mer), table


def run_finetuning(train_manifest_path: str, model_dir: str, output_dir: str, *,
                   freeze_encoder: bool = False,
                   run_cfg: DistillRunConfig = DistillRunConfig(),
                   opt_cfg: Optional[OptimConfig] = None,
                   prep_cfg: TrainPrepConfig = TrainPrepConfig(),
                   tokenizer_dir: Optional[str] = None,
                   eval_manifest_path: Optional[str] = None,
                   policy: DtypePolicy = DtypePolicy(), device=None) -> Dict[str, float]:
    """Plain CE seq2seq fine-tuning: the same loop with no teacher."""
    return run_distillation(
        train_manifest_path, model_dir, output_dir, student_dir=model_dir, run_cfg=run_cfg,
        dcfg=DistillConfig(ce_weight=1.0, kl_weight=0.0, mse_weight=0.0,
                           freeze_encoder=freeze_encoder),
        opt_cfg=opt_cfg, prep_cfg=prep_cfg, tokenizer_dir=tokenizer_dir,
        eval_manifest_path=eval_manifest_path, policy=policy, device=device)
