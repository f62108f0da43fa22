"""Stage 3 end to end on the CPU: the port's ``cli distill`` and ``cli
finetune`` (``--device cpu --compute_dtype fp32``) against the JAX
package's ``run_distillation`` / ``run_finetuning`` (fp32 policy, batch 8
sharded over the 8 virtual devices) on the same tiny checkpoint and WAV
segment manifest, 4 steps; ``cli init-student``; and a run resumed after 2
of 4 steps against 4 straight steps."""

import json
import os

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.audio.io import write_wav
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline.dataset import TrainPrepConfig
from taiwan_whisper_tpu.pipeline.distill_driver import (DistillRunConfig, run_distillation,
                                                        run_finetuning)
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL, bytes_to_unicode
from taiwan_whisper_tpu.train.state import OptimConfig
from taiwan_whisper_tpu_torch import cli
from taiwan_whisper_tpu_torch.models.io import read_safetensors

TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128, encoder_layers=1,
            decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
            max_source_positions=60, max_target_positions=64)
STEPS, BATCH, LR = 4, 8, 1e-3
TEXTS = [
    "<|0.00|>你好 hello<|0.40|><|0.50|>world 世界<|1.00|><|endoftext|>",
    "<|0.00|>第二段 second<|0.60|><|0.70|>跨越邊界<|1.10|><|continued|><|endoftext|>",
    "<|0.00|>no prompt here<|0.90|><|endoftext|>",
    "plain text without any marker 中文",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny teacher checkpoint, a byte-level vocab and 8 WAV segments
    with 2-line transcripts (timestamps, <|continued|>, prompts)."""
    d = tmp_path_factory.mktemp("stage3")
    jax_save(str(d / "teacher"), jax_init_params(JaxConfig(**TINY), seed=0), JaxConfig(**TINY))
    tok = d / "tok"
    tok.mkdir()
    (tok / "vocab.json").write_text(
        json.dumps({ch: i for i, ch in enumerate(bytes_to_unicode().values())}),
        encoding="utf-8")
    (tok / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    seg = d / "segments"
    seg.mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(8):
        write_wav(str(seg / f"s{i}.wav"),
                  (rng.randn(int((0.8 + 0.1 * i) * 16000)) * 0.1).astype(np.float32))
        prev = TEXTS[(i + 1) % len(TEXTS)] if i % 3 else ""
        (seg / f"s{i}.txt").write_text(f"{TEXTS[i % len(TEXTS)]}\n{prev}\n", encoding="utf-8")
        names.append(f"s{i}.wav")
    (d / "train.tsv").write_text(str(seg) + "\n" + "\n".join(names) + "\n", encoding="utf-8")
    return d


def _port(corpus, sub, out, *extra, steps=STEPS):
    args = [sub, "--manifest", str(corpus / "train.tsv"), "--output_dir", str(out),
            "--max_steps", str(steps), "--batch_size", str(BATCH), "--learning_rate", str(LR),
            "--warmup_steps", "1", "--tokenizer_dir", str(corpus / "tok"),
            "--device", "cpu", "--compute_dtype", "fp32", *extra]
    return cli.main(args)


def _jax_run(fn, corpus, out, **kw):
    return fn(str(corpus / "train.tsv"), str(corpus / "teacher"), str(out),
              opt_cfg=OptimConfig(learning_rate=LR, warmup_steps=1, total_steps=STEPS),
              tokenizer_dir=str(corpus / "tok"), policy=JaxPolicy.fp32(), **kw)


def _assert_exports_close(a, b, atol):
    ta = read_safetensors(os.path.join(a, "hf_export", "model.safetensors"))
    tb = read_safetensors(os.path.join(b, "hf_export", "model.safetensors"))
    assert set(ta) == set(tb)
    for k in ta:
        np.testing.assert_allclose(ta[k].numpy(), tb[k].numpy(), atol=atol, rtol=0, err_msg=k)


def _assert_metrics_close(port, ref, keys):
    for k in keys:
        np.testing.assert_allclose(port[k], float(ref[k]), rtol=1e-4, err_msg=k)


def test_cli_distill_matches_jax_and_resumes(tmp_path, corpus):
    teacher = ("--teacher", str(corpus / "teacher"), "--student_decoder_layers", "1")
    port = _port(corpus, "distill", tmp_path / "port", *teacher)
    ref = _jax_run(run_distillation, corpus, tmp_path / "jax", student_decoder_layers=1,
                   run_cfg=DistillRunConfig(max_steps=STEPS, batch_size=BATCH))
    _assert_metrics_close(port, ref, ("loss", "ce", "kl"))
    _assert_exports_close(tmp_path / "port", tmp_path / "jax", atol=1e-5)
    assert os.path.isfile(tmp_path / "port" / "checkpoints" / f"checkpoint-{STEPS}" / "state.pt")
    # stop after 2 steps, resume to 4: the same params as 4 straight steps
    _port(corpus, "distill", tmp_path / "resumed", *teacher, steps=2)
    resumed = _port(corpus, "distill", tmp_path / "resumed", *teacher)
    assert resumed["loss"] == port["loss"]
    _assert_exports_close(tmp_path / "resumed", tmp_path / "port", atol=0)


def test_cli_finetune_trainable_encoder_matches_jax(tmp_path, corpus):
    port = _port(corpus, "finetune", tmp_path / "port", "--model", str(corpus / "teacher"))
    ref = _jax_run(run_finetuning, corpus, tmp_path / "jax", freeze_encoder=False,
                   run_cfg=DistillRunConfig(max_steps=STEPS, batch_size=BATCH,
                                            mix_lang_embeddings=False),
                   prep_cfg=TrainPrepConfig(language="zh"))
    assert "kl" not in port
    _assert_metrics_close(port, ref, ("loss", "ce"))
    _assert_exports_close(tmp_path / "port", tmp_path / "jax", atol=1e-5)
    a = read_safetensors(str(tmp_path / "port" / "hf_export" / "model.safetensors"))
    t = read_safetensors(str(corpus / "teacher" / "model.safetensors"))
    key = "model.encoder.layers.0.fc1.weight"
    assert not torch.equal(a[key], t[key])  # the encoder trained


def test_cli_init_student_matches_jax(tmp_path, corpus):
    from taiwan_whisper_tpu import cli as jax_cli

    argv = ["init-student", "--teacher", str(corpus / "teacher"), "--decoder_layers", "1",
            "--mix_lang_emb"]
    jax_cli.main(argv + ["--out", str(tmp_path / "jax")])
    cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["decoder_layers"] == 1
    ta = read_safetensors(str(tmp_path / "port" / "model.safetensors"))
    tj = read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    assert set(ta) == set(tj)
    for k in ta:
        assert ta[k].dtype == torch.float32 and torch.equal(ta[k], tj[k]), k
