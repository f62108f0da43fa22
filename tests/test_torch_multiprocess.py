"""The port's multi-process runs on the CPU (gloo ranks, each a process of
its own, launched as torchrun would: tests/torch_spawn.py), against the
JAX package's single-process run and the port's own, at the fp32 policy:

* ``cli label --distributed`` and ``cli prefilter --distributed`` on 2
  ranks write the JAX CLI's files byte for byte (each rank its shard);
* label -> segment -> prefilter -> distill on 2 ranks, as
  tests/test_multiprocess.py::test_two_process_full_pipeline runs it for
  data parallel, against the same pipeline in one process: label CSVs and
  ``hallucination_result.csv`` byte-equal, disjoint hyp shards, losses
  within 1e-5 relative and exported parameters within 1e-6;
* ``cli distill --wandb --eval_manifest ... --gen_eval_batches 1`` (one
  process; no wandb here, so both packages log that and go on) writes the
  JAX CLI's ``metrics.jsonl`` records, the generation eval's MER and
  prediction tables included.
"""

import filecmp
import glob
import json
import os

import numpy as np
import pytest

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import distill_driver as jax_driver
from taiwan_whisper_tpu.pipeline import label as jax_label
from taiwan_whisper_tpu.pipeline import prefilter as jax_pf
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL, bytes_to_unicode
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.audio.io import write_flac, write_wav
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, read_manifest, write_manifest
from taiwan_whisper_tpu_torch.models.io import read_safetensors
from taiwan_whisper_tpu_torch.pipeline.segment import Utterance, segment_audio_file
from torch_spawn import finish, start
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
TEXT = ["今天", "我們", "來", "討論", "語音", "模型", "hello", "world", "的", "測試", "，"]


def _cfg(dec_layers, positions):
    return JaxConfig(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
                     encoder_layers=1, decoder_layers=dec_layers, encoder_attention_heads=4,
                     decoder_attention_heads=4, max_source_positions=60,
                     max_target_positions=positions)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny teacher (64 positions) and validator (448: the prefilter's
    budget), a byte-level vocab, 4 FLAC clips of 2.5 s (the labelling
    input) and 7 FLAC segments of a seeded lecture with their 2-line txts
    (the prefilter input)."""
    d = tmp_path_factory.mktemp("multiprocess")
    jax_save(str(d / "teacher"), jax_init_params(_cfg(2, 64), seed=0), _cfg(2, 64))
    jax_save(str(d / "validator"), jax_init_params(_cfg(1, 448), seed=1), _cfg(1, 448))
    tok = d / "tok"
    tok.mkdir()
    (tok / "vocab.json").write_text(
        json.dumps({ch: i for i, ch in enumerate(bytes_to_unicode().values())}),
        encoding="utf-8")
    (tok / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    rng = np.random.RandomState(7)
    (d / "raw").mkdir()
    names = []
    for i in range(4):
        names.append(f"lec{i}.flac")
        write_flac(str(d / "raw" / names[-1]),
                   (rng.randn(int(2.5 * SR)) * 0.1).astype(np.float32))
    write_manifest(str(d / "raw.tsv"), Manifest(root=str(d / "raw"), paths=names))
    t = np.arange(240 * SR) / SR
    audio = (rng.randn(len(t)) * 0.3 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
             ).astype(np.float32)
    utts, s = [], 0.0
    while s < 235.0:
        e = s + float(rng.uniform(2, 12))
        utts.append(Utterance(round(s, 3), round(e, 3), "".join(rng.choice(TEXT, 5))))
        s = e + float(rng.uniform(0, 1))
    rels = segment_audio_file(audio, utts, str(d / "seg"), "lec")[:7]
    assert len(rels) == 7
    write_manifest(str(d / "seg.tsv"), Manifest(root=str(d / "seg"), paths=rels))
    return d


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _hyp_indices(path):
    with open(path, encoding="utf-8") as f:
        return {int(line.split("\t")[0]) for line in f if "\t" in line}


# cli.main on one rank, each package's default policy fp32 (the label and
# prefilter CLIs have no policy flag)
CLI_WORKER = r"""
import sys
from taiwan_whisper_tpu_torch import cli
from taiwan_whisper_tpu_torch.models.config import DtypePolicy
from taiwan_whisper_tpu_torch.pipeline import label, prefilter
label.run_labelling.__kwdefaults__["policy"] = DtypePolicy.fp32()
prefilter.run_prefilter.__kwdefaults__["policy"] = DtypePolicy.fp32()
cli.main(sys.argv[1:])
"""


def test_two_rank_cli_label_and_prefilter_match_jax(tmp_path, corpus, monkeypatch):
    """``cli label`` (batch 2, VAD off, 16 tokens) over 4 files and ``cli
    prefilter`` (batch 2, the 448-token budget) over 7 segments, each as 2
    ranks with ``--distributed --device cpu``: every label CSV and the
    prefilter's ``hallucination_result.csv`` and cleaned TSV equal the JAX
    CLI's single-process files; rank 0 labelled lec0-1 and rank 1 lec2-3,
    and the hyp shards are disjoint, non-empty and cover every segment."""
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (jax_label.LabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setattr(jax_pf.validator_transcribe, "__defaults__",
                        (jax_pf.PrefilterConfig(), JaxPolicy.fp32()))
    label = ["label", "--manifest", str(corpus / "raw.tsv"), "--model", str(corpus / "teacher"),
             "--tokenizer_dir", str(corpus / "tok"), "--batch_size", "2", "--vad_mode", "off",
             "--max_decode_tokens", "16"]
    prefilter = ["prefilter", "--manifest", str(corpus / "seg.tsv"), "--validator",
                 str(corpus / "validator"), "--tokenizer_dir", str(corpus / "tok"),
                 "--batch_size", "2"]
    port = ["--distributed", "--device", "cpu"]
    ranks = start(CLI_WORKER, 2, label + ["--output_dir", tmp_path / "port_label"] + port)
    jax_cli.main(label + ["--output_dir", str(tmp_path / "jax_label")])
    outs = finish(ranks)
    assert ['"files": 2' in out for out in outs] == [True, True]
    names = sorted(os.listdir(tmp_path / "jax_label"))
    assert names == [f"lec{i}.csv" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "port_label")) == names
    for n in names:
        assert _read(tmp_path / "port_label" / n) == _read(tmp_path / "jax_label" / n), n

    ranks = start(CLI_WORKER, 2, prefilter + ["--output_dir", tmp_path / "port_pf"] + port)
    jax_cli.main(prefilter + ["--output_dir", str(tmp_path / "jax_pf")])
    finish(ranks, timeout=180)
    for name in ("hallucination_result.csv", "train_non-hallucinated-threshold0.4.tsv"):
        assert _read(tmp_path / "port_pf" / name) == _read(tmp_path / "jax_pf" / name), name
    shards = [_hyp_indices(tmp_path / "port_pf" / f"idx_hyp.{r}.txt") for r in (0, 1)]
    assert shards == [{0, 1, 2, 3}, {4, 5, 6}]
    assert _hyp_indices(tmp_path / "jax_pf" / "idx_hyp.0.txt") == set(range(7))


# label -> segment -> prefilter -> distill as tests/test_multiprocess.py's
# PIPELINE_WORKER runs it, through the port; argv: workdir, output name
PIPELINE_WORKER = r"""
import glob
import os
import sys

from taiwan_whisper_tpu_torch.audio.io import load_audio_16k
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, read_manifest, write_manifest
from taiwan_whisper_tpu_torch.models.config import DtypePolicy
from taiwan_whisper_tpu_torch.parallel import mesh
from taiwan_whisper_tpu_torch.pipeline.dataset import TrainPrepConfig
from taiwan_whisper_tpu_torch.pipeline.distill_driver import DistillRunConfig, run_distillation
from taiwan_whisper_tpu_torch.pipeline.label import LabelConfig, run_labelling
from taiwan_whisper_tpu_torch.pipeline.prefilter import PrefilterConfig, run_prefilter
from taiwan_whisper_tpu_torch.pipeline.segment import (Utterance, read_pseudo_label_csv,
                                                       segment_audio_file)

workdir, outname = sys.argv[1], sys.argv[2]
if int(os.environ["WORLD_SIZE"]) > 1:
    mesh.init_distributed("cpu")
fp32, tok_dir = DtypePolicy.fp32(), os.path.join(workdir, "tok")
out = os.path.join(workdir, outname)
label_dir = os.path.join(out, "labels")
run_labelling(os.path.join(workdir, "raw.tsv"), os.path.join(workdir, "teacher"), label_dir,
              LabelConfig(batch_size=2, vad_mode="off", max_decode_tokens=16),
              tokenizer_dir=tok_dir, policy=fp32, device="cpu")
mesh.barrier("label_done")

# segment this rank's files, with utterances crossing the 30 s window
# boundary appended so that distill always has data; rank 0 merges
manifest = read_manifest(os.path.join(workdir, "raw.tsv"))
seg_dir = os.path.join(out, "segments")
sl = mesh.host_local_slice(len(manifest.paths))
rel = []
for relpath, abspath in zip(manifest.paths[sl], manifest.absolute_paths()[sl]):
    stem = os.path.splitext(os.path.basename(relpath))[0]
    utts = read_pseudo_label_csv(os.path.join(label_dir, stem + ".csv")) + [
        Utterance(0.0, 10.0, "hello " + stem), Utterance(10.0, 29.0, "again " + stem),
        Utterance(29.0, 45.0, "crosses the boundary " + stem)]
    rel.extend(segment_audio_file(load_audio_16k(abspath), utts, seg_dir, stem))
with open(os.path.join(out, "seg_paths.%d.txt" % mesh.rank()), "w") as f:
    f.write("".join(p + "\n" for p in rel))
mesh.barrier("segment_shards_written")
seg_tsv = os.path.join(out, "segments.tsv")
if mesh.is_main():
    paths = []
    for shard in sorted(glob.glob(os.path.join(out, "seg_paths.*.txt"))):
        with open(shard) as f:
            paths.extend(line.strip() for line in f if line.strip())
    write_manifest(seg_tsv, Manifest(root=seg_dir, paths=sorted(paths) * 4))
mesh.barrier("segments_merged")

run_prefilter(seg_tsv, os.path.join(workdir, "validator"), out,
              PrefilterConfig(batch_size=2, threshold=100.0), tokenizer_dir=tok_dir,
              policy=fp32, device="cpu")
mesh.barrier("prefilter_done")

metrics = run_distillation(
    os.path.join(out, "train_non-hallucinated-threshold100.0.tsv"),
    os.path.join(workdir, "teacher"), os.path.join(out, "distill"), student_decoder_layers=1,
    run_cfg=DistillRunConfig(max_steps=2, batch_size=4, save_steps=2, logging_steps=1,
                             resume=False, num_workers=0),
    prep_cfg=TrainPrepConfig(max_label_length=48), tokenizer_dir=tok_dir, policy=fp32,
    device="cpu")
print("FINAL_LOSS %r" % metrics["loss"])
mesh.shutdown()
"""


def test_two_rank_pipeline_matches_one_process(corpus):
    """The 2-rank run's merged files equal the 1-process run's: label CSVs,
    the segment and cleaned manifests' paths, ``hallucination_result.csv``
    byte for byte; each rank wrote a disjoint, non-empty hyp shard; rank 0
    wrote the checkpoint and HF export; the losses of both steps agree to
    1e-5 relative and the exported parameters to 1e-6."""
    one = start(PIPELINE_WORKER, 1, [corpus, "sp"])
    two = start(PIPELINE_WORKER, 2, [corpus, "dp"])
    finish(one, timeout=240)
    finish(two, timeout=240)
    sp, dp = corpus / "sp", corpus / "dp"
    for i in range(4):
        assert filecmp.cmp(sp / "labels" / f"lec{i}.csv", dp / "labels" / f"lec{i}.csv",
                           shallow=False), i
    for name in ("segments.tsv", "train_non-hallucinated-threshold100.0.tsv"):
        a, b = read_manifest(str(sp / name)), read_manifest(str(dp / name))
        assert a.paths and a.paths == b.paths and a.frames == b.frames, name
    assert _read(sp / "hallucination_result.csv") == _read(dp / "hallucination_result.csv")
    shards = [_hyp_indices(p) for p in sorted(glob.glob(str(dp / "idx_hyp.*.txt")))]
    assert len(shards) == 2 and all(shards) and not shards[0] & shards[1]
    assert shards[0] | shards[1] == _hyp_indices(sp / "idx_hyp.0.txt")
    assert os.path.isfile(dp / "distill" / "checkpoints" / "checkpoint-2" / "state.pt")

    def losses(run):
        with open(run / "distill" / "metrics.jsonl") as f:
            return [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]

    assert len(losses(sp)) == 2
    np.testing.assert_allclose(losses(dp), losses(sp), rtol=1e-5)
    a = read_safetensors(str(sp / "distill" / "hf_export" / "model.safetensors"))
    b = read_safetensors(str(dp / "distill" / "hf_export" / "model.safetensors"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6, rtol=0, err_msg=k)


def test_cli_distill_wandb_and_gen_eval_match_jax_cli(tmp_path, corpus, monkeypatch, capsys):
    """``cli distill --wandb --eval_manifest --gen_eval_batches 1`` (batch
    8, 2 steps, eval at step 2) at fp32: wandb is absent, so each logger
    says so and goes on; the port's ``metrics.jsonl`` records, less their
    ``time`` and the measured ``train/steps_per_s``, equal the JAX CLI's:
    the same records in the same order, the losses to 1e-4 relative, the
    generation eval's MER and both prediction tables exactly."""
    seg = tmp_path / "seg"
    seg.mkdir()
    rng = np.random.RandomState(0)
    texts = ["<|0.00|>你好 hello<|0.40|><|0.50|>world 世界<|1.00|><|endoftext|>",
             "第二段 second 測試", "<|0.00|>no prompt here<|0.90|><|endoftext|>"]
    for i in range(8):
        write_wav(str(seg / f"s{i}.wav"),
                  (rng.randn(int((0.8 + 0.1 * i) * SR)) * 0.1).astype(np.float32))
        (seg / f"s{i}.txt").write_text(f"{texts[i % 3]}\n\n", encoding="utf-8")
    write_manifest(str(tmp_path / "train.tsv"),
                   Manifest(root=str(seg), paths=[f"s{i}.wav" for i in range(8)]))
    monkeypatch.setitem(jax_driver.run_distillation.__kwdefaults__, "policy", JaxPolicy.fp32())
    argv = ["distill", "--manifest", str(tmp_path / "train.tsv"), "--teacher",
            str(corpus / "teacher"), "--student_decoder_layers", "1", "--max_steps", "2",
            "--batch_size", "8", "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--eval_steps", "2", "--tokenizer_dir", str(corpus / "tok"), "--wandb",
            "--eval_manifest", str(tmp_path / "train.tsv"), "--gen_eval_batches", "1"]
    jax_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    capsys.readouterr()
    port_cli.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu",
                          "--compute_dtype", "fp32"])
    assert "[metrics] wandb unavailable (No module named 'wandb'); continuing without" in \
        capsys.readouterr().out

    def records(run):
        with open(tmp_path / run / "metrics.jsonl", encoding="utf-8") as f:
            out = [json.loads(line) for line in f]
        for r in out:
            r.pop("time")
            r.pop("train/steps_per_s", None)
        return out

    got, want = records("port"), records("jax")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r.get("table") for r in got] == [None, None, None, "eval/predictions",
                                             "eval/incorrect_predictions"]
    assert len(got[3]["rows"]) == 8 and "eval/gen_mer" in got[2]
    for g, w in zip(got, want):
        if "table" in g:
            assert g == w
            continue
        assert g["step"] == w["step"]
        for k in g:
            if k == "eval/gen_mer":
                assert g[k] == w[k]
            elif k != "step":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
