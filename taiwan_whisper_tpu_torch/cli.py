"""Command line of the PyTorch port.

    python -m taiwan_whisper_tpu_torch.cli label --manifest ... --model ... \\
        --output_dir ... [--validation_manifest ...] [--assistant DIR] [--device cuda|cpu]
    python -m taiwan_whisper_tpu_torch.cli segment --trans_dir ... --audio_dir ... \\
        --output_dir ...
    python -m taiwan_whisper_tpu_torch.cli make-manifest --root ... --out ...
    python -m taiwan_whisper_tpu_torch.cli prefilter --manifest ... --validator ... \\
        --output_dir ... [--device cuda|cpu]
    python -m taiwan_whisper_tpu_torch.cli collect-hallucinations --original_tsv ... \\
        --cleaned_tsv ... --hyp_tsv ... --output_dir ...
    python -m taiwan_whisper_tpu_torch.cli init-student --teacher ... --out ...
    python -m taiwan_whisper_tpu_torch.cli distill --manifest ... --teacher ... \\
        --output_dir ... [--device cuda|cpu]
    python -m taiwan_whisper_tpu_torch.cli finetune --manifest ... --model ... \\
        --output_dir ... [--freeze_encoder] [--device cuda|cpu]
    python -m taiwan_whisper_tpu_torch.cli evaluate --manifest ... --model ... \\
        [--mode short|sequential|chunked|speculative] [--assistant DIR] [--num_beams N] \\
        [--device cuda|cpu]
    python -m taiwan_whisper_tpu_torch.cli transcribe --audio ... --model ... \\
        --output_dir ... [--strategy chunked|sequential] [--format srt|vtt|txt|json]
    python -m taiwan_whisper_tpu_torch.cli sweep --config sweep.yaml --target distill \\
        --output_dir ... [--max_runs N] [--agent] --extra --manifest ... [--device cpu]

Each subcommand takes the JAX CLI's flags and defaults
(taiwan_whisper_tpu/cli.py); those that run a model also take
``--device``, and ``distill`` and ``finetune`` ``--compute_dtype`` (bf16,
the JAX CLI's policy, or fp32) and ``--logging_steps``. label's and
evaluate's ``--assistant`` load the draft model on the same device.
``sweep`` runs no model itself: each of its runs is a call of this CLI's
``main`` with the sweep's parameters and the ``--extra`` arguments, which
carry ``--device``.

Multi-process runs: launch the same command once per process with
``--distributed``, e.g.

    torchrun --nproc_per_node N -m taiwan_whisper_tpu_torch.cli label ... --distributed

Each process joins the run from the launcher's environment
(``parallel.init_distributed``; raises when a variable is missing) and runs
on ``cuda:<LOCAL_RANK>`` unless ``--device`` names another. label and
prefilter shard the manifest by rank, evaluate and transcribe shard
nothing. distill and finetune lay the ranks out as a ``(data, model)``
grid with ``--model_parallel M`` consecutive ranks to a model group
(``parallel.mesh.make_mesh``; the world must divide by M, and heads,
``d_model`` and ``ffn_dim`` too): each model group holds the weights split
Megatron-style over its ranks (tensor parallel, ``parallel/specs.py``;
the model's all-reduces run over the model group) and trains on its
slice of the rows of the global ``--batch_size``, the gradients, token
count and metrics summed over the data group. M = 1, the default, is
plain data parallel over every rank.

    torchrun --nproc_per_node 4 -m taiwan_whisper_tpu_torch.cli distill ... \\
        --distributed --model_parallel 2
"""

from __future__ import annotations

import argparse
import glob
import json
import os

def _quant_arg(v: str):
    """--quantize_kv value: off/0/false | 8/int8/true | 4/int4 | fp8."""
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "none"):
        return 0
    if s in ("8", "int8", "true", "1"):
        return 8
    if s in ("4", "int4"):
        return 4
    if s in ("fp8", "e4m3", "float8"):
        return "fp8"
    raise argparse.ArgumentTypeError(f"--quantize_kv must be off/8/4/fp8, got {v!r}")


def cmd_label(args):
    from .pipeline.label import LabelConfig, run_labelling

    stats = run_labelling(
        args.manifest, args.model, args.output_dir,
        LabelConfig(
            language=args.language, strategy=args.strategy,
            batch_size=args.batch_size,
            energy_vad_threshold=args.energy_vad_threshold,
            vad_regions=args.vad_mode != "off",
            vad_mode=args.vad_mode,
            quantize_kv=args.quantize_kv,
            num_beams=args.num_beams,
            pooled=not args.no_pooled,
            wire_mode=args.wire_mode,
            max_decode_tokens=args.max_decode_tokens,
            pack_regions=args.pack_regions,
            group_segs=args.group_segs,
            num_draft_tokens=args.num_draft_tokens,
        ),
        tokenizer_dir=args.tokenizer_dir,
        assistant_dir=args.assistant,
        validation_manifest=args.validation_manifest,
        device=args.device,
    )
    print(json.dumps(stats))
    return stats


def cmd_segment(args):
    from .audio.io import load_audio_16k
    from .audio.manifest import Manifest, write_manifest
    from .pipeline.segment import read_pseudo_label_csv, segment_audio_file

    csvs = {os.path.splitext(os.path.basename(p))[0]: p
            for p in glob.glob(os.path.join(args.trans_dir, "*.csv"))}
    rel_paths = []
    for audio_path in sorted(glob.glob(os.path.join(args.audio_dir, f"*.{args.ext}"))):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        if stem not in csvs:
            print(f"[segment] no transcription for {stem}")
            continue
        rel_paths.extend(segment_audio_file(load_audio_16k(audio_path),
                                            read_pseudo_label_csv(csvs[stem]),
                                            args.output_dir, stem, audio_format=args.ext))
    write_manifest(os.path.join(args.output_dir, "train.tsv"),
                   Manifest(root=os.path.abspath(args.output_dir), paths=rel_paths))
    print(f"[segment] wrote {len(rel_paths)} segments")


def cmd_make_manifest(args):
    from .audio.manifest import Manifest, split_valid, write_manifest

    paths = sorted(os.path.relpath(p, args.root)
                   for p in glob.glob(os.path.join(args.root, "**", f"*.{args.ext}"),
                                      recursive=True))
    m = Manifest(root=os.path.abspath(args.root), paths=paths)
    if args.valid_percent > 0:
        train, valid = split_valid(m, args.valid_percent, args.seed)
        write_manifest(os.path.join(args.out, "train.tsv"), train)
        write_manifest(os.path.join(args.out, "valid.tsv"), valid)
        print(f"[manifest] train={len(train)} valid={len(valid)}")
    else:
        write_manifest(os.path.join(args.out, "train.tsv"), m)
        print(f"[manifest] train={len(m)}")


def cmd_prefilter(args):
    """Returns the run's counts and times (``run_prefilter``'s stats)."""
    from .pipeline.prefilter import PrefilterConfig, run_prefilter

    stats: dict = {}
    run_prefilter(args.manifest, args.validator, args.output_dir,
                  PrefilterConfig(language=args.language, batch_size=args.batch_size,
                                  threshold=args.threshold, mix_detection=args.mix_detection),
                  tokenizer_dir=args.tokenizer_dir, device=args.device, stats=stats)
    return stats


def cmd_collect_hallucinations(args):
    from .pipeline.audit import collect_hallucinations

    collect_hallucinations(args.original_tsv, args.cleaned_tsv, args.hyp_tsv, args.output_dir,
                           num_samples=args.num_samples, seed=args.seed,
                           filter_csv=args.filter_csv, copy_audio=not args.no_audio)


def _policy(name: str):
    from .models.config import DtypePolicy

    return DtypePolicy.fp32() if name == "fp32" else DtypePolicy.bf16()


def cmd_distill(args):
    from .pipeline.dataset import TrainPrepConfig
    from .pipeline.distill_driver import DistillRunConfig, run_distillation
    from .train.distill import DistillConfig
    from .train.state import OptimConfig

    metrics = run_distillation(
        args.manifest, args.teacher, args.output_dir,
        student_dir=args.student,
        student_decoder_layers=args.student_decoder_layers,
        student_encoder_layers=args.student_encoder_layers,
        run_cfg=DistillRunConfig(
            max_steps=args.max_steps, batch_size=args.batch_size,
            model_parallel=args.model_parallel, save_steps=args.save_steps,
            eval_steps=args.eval_steps, logging_steps=args.logging_steps,
            use_wandb=args.wandb, gen_eval_batches=args.gen_eval_batches,
        ),
        dcfg=DistillConfig(
            ce_weight=args.ce_weight, kl_weight=args.kl_weight,
            temperature=args.temperature, mse_weight=args.mse_weight,
        ),
        opt_cfg=OptimConfig(
            learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
            total_steps=args.max_steps, schedule=args.lr_schedule,
        ),
        prep_cfg=TrainPrepConfig(
            language=args.language,
            timestamp_probability=args.timestamp_probability,
            condition_on_prev_probability=args.condition_on_prev_probability,
        ),
        tokenizer_dir=args.tokenizer_dir,
        eval_manifest_path=args.eval_manifest,
        policy=_policy(args.compute_dtype),
        device=args.device,
    )
    print(json.dumps(metrics))
    return metrics


def cmd_finetune(args):
    from .pipeline.dataset import TrainPrepConfig
    from .pipeline.distill_driver import DistillRunConfig, run_finetuning
    from .train.state import OptimConfig

    metrics = run_finetuning(
        args.manifest, args.model, args.output_dir,
        freeze_encoder=args.freeze_encoder,
        run_cfg=DistillRunConfig(
            max_steps=args.max_steps, batch_size=args.batch_size,
            model_parallel=args.model_parallel, save_steps=args.save_steps,
            eval_steps=args.eval_steps, logging_steps=args.logging_steps,
            mix_lang_embeddings=False,
        ),
        opt_cfg=OptimConfig(
            learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
            total_steps=args.max_steps,
        ),
        prep_cfg=TrainPrepConfig(language=args.language),
        tokenizer_dir=args.tokenizer_dir,
        eval_manifest_path=args.eval_manifest,
        policy=_policy(args.compute_dtype),
        device=args.device,
    )
    print(json.dumps(metrics))
    return metrics


def cmd_init_student(args):
    """Maximally-spaced student from a teacher checkpoint, written in fp32
    as the JAX package writes it; the slicing and mixing run on --device."""
    import torch

    from .models.config import resolve_device
    from .models.io import load_model, save_hf_checkpoint
    from .models.params import (init_student_from_teacher, map_params,
                                mix_language_embeddings)
    from .text.tokenizer import MULTILINGUAL

    dev = resolve_device(args.device)
    teacher, tcfg = load_model(args.teacher)
    teacher = map_params(lambda _, t: t.to(device=dev, dtype=torch.float32), teacher)
    if args.mix_lang_emb:
        zh, en = MULTILINGUAL.language_id("zh"), MULTILINGUAL.language_id("en")
        teacher = mix_language_embeddings(teacher, zh, [zh, en])
    layers = ([int(x) for x in args.decoder_layers_numbers.split(",")]
              if args.decoder_layers_numbers else None)
    student = init_student_from_teacher(teacher, tcfg, args.decoder_layers, layers,
                                        encoder_layers=args.encoder_layers)
    scfg = tcfg.with_decoder_layers(args.decoder_layers)
    if args.encoder_layers is not None:
        scfg = scfg.with_encoder_layers(args.encoder_layers)
    save_hf_checkpoint(args.out, student, scfg)
    print(f"[init-student] wrote {args.out}")


def _load_for(args):
    """(params on --device in the checkpoint's dtype, config, tokenizer
    whose token layout the checkpoint's vocab size implies). The decode
    entry points cast the params to their policy."""
    from .models.config import resolve_device
    from .models.io import load_model
    from .models.params import map_params
    from .text.tokenizer import WhisperTokenizer, special_for_vocab

    dev = resolve_device(args.device)
    params, config = load_model(args.model)
    params = map_params(lambda _, t: t.to(dev), params)
    special = special_for_vocab(config.vocab_size)
    tok = (WhisperTokenizer.from_pretrained_dir(args.tokenizer_dir, special=special)
           if args.tokenizer_dir else WhisperTokenizer(special))
    return params, config, tok, dev


def cmd_evaluate(args):
    from .models.io import load_model
    from .models.params import map_params
    from .pipeline.evaluate import EvalConfig, evaluate_manifest

    params, config, tok, dev = _load_for(args)
    assistant = None
    if args.assistant:
        a_params, a_config = load_model(args.assistant)
        assistant = (map_params(lambda _, t: t.to(dev), a_params), a_config)
    res = evaluate_manifest(
        params, config, tok, args.manifest,
        EvalConfig(language=args.language, mode=args.mode, batch_size=args.batch_size,
                   num_beams=args.num_beams),
        output_dir=args.output_dir, assistant=assistant, device=dev)
    metrics = {"mer": res.mer, "en_wer": res.en_wer, "zh_cer": res.zh_cer, "rtf": res.rtf,
               "audio_seconds_per_second": res.audio_seconds_per_second,
               "n_samples": res.n_samples}
    print(json.dumps(metrics))
    return metrics


def cmd_transcribe(args):
    """Long-form transcription of audio files to txt, srt, vtt or json."""
    from .audio.io import load_audio_16k
    from .decode.longform import chunked_decode, sequential_decode
    from .text.subtitles import Cue, write_srt, write_vtt

    params, config, tok, dev = _load_for(args)
    language = None if args.language.lower() in ("none", "") else args.language
    files = []
    for pattern in args.audio:
        if os.path.isdir(pattern):
            files.extend(sorted(glob.glob(os.path.join(pattern, "*.flac")))
                         + sorted(glob.glob(os.path.join(pattern, "*.wav"))))
        else:
            files.extend(sorted(glob.glob(pattern)) or [pattern])
    os.makedirs(args.output_dir, exist_ok=True)
    results = {}
    for path in files:
        audio = load_audio_16k(path)
        if args.strategy == "sequential":
            res = sequential_decode(params, audio, config, tok, language=language,
                                    quantize_cross_kv=args.quantize_kv,
                                    num_beams=args.num_beams, device=dev)
        else:
            res = chunked_decode(params, audio, config, tok, language=language,
                                 batch_size=args.batch_size, quantize_cross_kv=args.quantize_kv,
                                 num_beams=args.num_beams, device=dev)
        stem = os.path.splitext(os.path.basename(path))[0]
        cues = [Cue(s.start, s.end, s.text(tok)) for s in res.segments]
        out_base = os.path.join(args.output_dir, stem)
        if args.format == "txt":
            with open(out_base + ".txt", "w", encoding="utf-8") as f:
                f.write(res.text(tok).strip() + "\n")
        elif args.format == "srt":
            write_srt(out_base + ".srt", cues)
        elif args.format == "vtt":
            write_vtt(out_base + ".vtt", cues)
        else:
            with open(out_base + ".json", "w", encoding="utf-8") as f:
                json.dump([{"start": c.start, "end": c.end, "text": c.text} for c in cues],
                          f, ensure_ascii=False, indent=1)
        results[path] = len(cues)
        print(f"[transcribe] {path}: {len(cues)} segments")
    return results


def cmd_sweep(args):
    from .pipeline.sweep import run_sweep, run_sweep_agent

    if not args.agent and not args.config:
        raise SystemExit("sweep: --config is required without --agent")
    if args.agent:
        summary = run_sweep_agent(
            args.config, args.target, args.output_dir,
            extra_argv=args.extra, sweep_id=args.sweep_id,
            project=args.project, entity=args.entity, count=args.count,
        )
    else:
        summary = run_sweep(
            args.config, args.target, args.output_dir,
            extra_argv=args.extra, max_runs=args.max_runs, seed=args.seed,
        )
    print(json.dumps(summary))
    return summary


def _add_model_common(p: argparse.ArgumentParser):
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with vocab.json/merges.txt (optional)")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process run from the launcher's environment "
                        "(torchrun) first")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; 'cpu' runs the "
                        "plain PyTorch path)")


def _add_train_common(p: argparse.ArgumentParser):
    _add_model_common(p)
    p.add_argument("--compute_dtype", default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype over the fp32 master weights")
    p.add_argument("--logging_steps", type=int, default=25)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="taiwan_whisper_tpu_torch",
                                 fromfile_prefix_chars="@")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("label", help="stage 1: pseudo-label long audio")
    p.add_argument("--manifest", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--language", default="zh")
    p.add_argument("--strategy", default="chunked", choices=["chunked", "sequential"])
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--energy_vad_threshold", type=float, default=0.0)
    p.add_argument("--vad_mode", default="spectral",
                   choices=["spectral", "spectral-device", "spectral-host",
                            "energy", "off"],
                   help="region-gated decode: spectral, spectral-device, "
                        "spectral-host, energy, or off (whole file). The resident "
                        "route scores spectral with the PyTorch scorer on --device; "
                        "the chunk route scores spectral on the device on CUDA and "
                        "with numpy elsewhere")
    p.add_argument("--quantize_kv", type=_quant_arg, nargs="?", const=8,
                   default=0, metavar="MODE",
                   help="cross-KV quantization: bare flag or 8 -> int8, 4 -> int4 "
                        "(packed two a byte), fp8 -> e4m3, off -> disabled")
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--no_pooled", action="store_true")
    p.add_argument("--wire_mode", default="auto", choices=["auto", "resident", "chunks"],
                   help="resident: one upload per file into device group buffers "
                        "(spectral/off VAD); chunks: staged chunk batches; auto: "
                        "resident when eligible")
    p.add_argument("--group_segs", type=int, default=None,
                   help="resident path: 120 s segments per device group buffer")
    p.add_argument("--pack_regions", action="store_true",
                   help="resident path: pack short VAD regions into shared windows")
    p.add_argument("--max_decode_tokens", type=int, default=None,
                   help="cap sampled tokens per 30 s chunk (None = model max 448)")
    p.add_argument("--assistant", default=None,
                   help="draft model dir: label with speculative decoding (a distilled "
                        "student drafts, the teacher verifies; one 30 s window at a time)")
    p.add_argument("--num_draft_tokens", type=int, default=5)
    p.add_argument("--validation_manifest", default=None,
                   help="labelled split (audio + transcript txts) to label too and score "
                        "the pseudo-labels against: MER, EN-WER, ZH-CER in the stats")
    _add_model_common(p)
    p.set_defaults(fn=cmd_label)

    p = sub.add_parser("segment", help="stage 2a: 30s re-segmentation")
    p.add_argument("--trans_dir", required=True)
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ext", default="flac")
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("prefilter", help="stage 2b: validator + MER filter")
    p.add_argument("--manifest", required=True)
    p.add_argument("--validator", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--language", default="zh")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--mix_detection", action="store_true")
    _add_model_common(p)
    p.set_defaults(fn=cmd_prefilter)

    p = sub.add_parser("collect-hallucinations",
                       help="sample N prefilter-dropped segments for human audit")
    p.add_argument("--original_tsv", required=True, help="manifest BEFORE the prefilter")
    p.add_argument("--cleaned_tsv", required=True,
                   help="non-hallucinated manifest written by `prefilter`")
    p.add_argument("--hyp_tsv", nargs="+", required=True,
                   help="validator idx\\thyp file(s), per-rank shards ok")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--filter_csv", default=None,
                   help="hallucination_result.csv for per-row MER + reason")
    p.add_argument("--no_audio", action="store_true", help="skip copying audio files")
    p.set_defaults(fn=cmd_collect_hallucinations)

    p = sub.add_parser("make-manifest", help="build fairseq-style TSVs")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ext", default="flac")
    p.add_argument("--valid_percent", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_make_manifest)

    p = sub.add_parser("distill", help="stage 3: knowledge distillation")
    p.add_argument("--manifest", required=True)
    p.add_argument("--teacher", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--student", default=None)
    p.add_argument("--student_decoder_layers", type=int, default=2)
    p.add_argument("--student_encoder_layers", type=int, default=None,
                   help="slice the teacher encoder to N max-spaced layers")
    p.add_argument("--max_steps", type=int, default=120_000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--lr_schedule", default="constant_with_warmup")
    p.add_argument("--ce_weight", type=float, default=0.8)
    p.add_argument("--kl_weight", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--mse_weight", type=float, default=0.0)
    p.add_argument("--language", default="zh")
    p.add_argument("--timestamp_probability", type=float, default=0.2)
    p.add_argument("--condition_on_prev_probability", type=float, default=0.2)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--eval_manifest", default=None)
    p.add_argument("--gen_eval_batches", type=int, default=0)
    _add_train_common(p)
    p.set_defaults(fn=cmd_distill)

    p = sub.add_parser("finetune", help="CE-only seq2seq fine-tuning")
    p.add_argument("--manifest", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_steps", type=int, default=10_000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--language", default="zh")
    p.add_argument("--eval_manifest", default=None)
    _add_train_common(p)
    p.set_defaults(fn=cmd_finetune)

    p = sub.add_parser("evaluate", help="stage 4: MER + RTF eval")
    p.add_argument("--manifest", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--language", default="zh",
                   help="forced language; 'none' for *.en models")
    p.add_argument("--mode", default="short",
                   choices=["short", "sequential", "chunked", "speculative"])
    p.add_argument("--assistant", default=None,
                   help="assistant (draft) model dir for --mode speculative")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_beams", type=int, default=1)
    _add_model_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("transcribe", help="long-form ASR -> txt/srt/vtt/json")
    p.add_argument("--audio", nargs="+", required=True,
                   help="audio files, globs, or directories")
    p.add_argument("--model", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--language", default="zh",
                   help="forced language; 'none' for *.en models")
    p.add_argument("--strategy", default="chunked", choices=["chunked", "sequential"])
    p.add_argument("--format", default="srt", choices=["txt", "srt", "vtt", "json"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--quantize_kv", type=_quant_arg, nargs="?", const=8,
                   default=0, metavar="MODE",
                   help="off/8/4/fp8 (bare flag = int8)")
    p.add_argument("--num_beams", type=int, default=1)
    _add_model_common(p)
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("sweep", help="HP sweep over a wandb-style YAML: local expansion "
                                     "(default) or a hosted wandb agent (--agent)")
    p.add_argument("--config", default=None,
                   help="sweep YAML path (required unless --agent with --sweep_id)")
    p.add_argument("--target", required=True, choices=["distill", "finetune", "evaluate"],
                   help="subcommand every run invokes")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_runs", type=int, default=0,
                   help="cap grid size / number of random samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--agent", action="store_true",
                   help="join/create a HOSTED wandb sweep (needs wandb + network)")
    p.add_argument("--sweep_id", default=None,
                   help="existing wandb sweep to join (with --agent)")
    p.add_argument("--project", default=None)
    p.add_argument("--entity", default=None)
    p.add_argument("--count", type=int, default=None, help="max runs this agent executes")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra argv appended to every run (e.g. --device cpu)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("init-student", help="maximally-spaced student init")
    p.add_argument("--teacher", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--decoder_layers", type=int, default=2)
    p.add_argument("--decoder_layers_numbers", default=None,
                   help="comma-separated explicit teacher layer indices")
    p.add_argument("--encoder_layers", type=int, default=None,
                   help="slice the encoder to N max-spaced teacher layers")
    p.add_argument("--mix_lang_emb", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; 'cpu' runs on the CPU)")
    p.set_defaults(fn=cmd_init_student)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not getattr(args, "distributed", False):
        return args.fn(args)
    from .parallel import init_distributed, shutdown

    init_distributed(args.device)
    try:
        return args.fn(args)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
