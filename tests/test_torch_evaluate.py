"""``cli evaluate`` and ``cli transcribe`` of the port against the JAX CLI
at the fp32 policy (each package's default policy patched to fp32, as
neither CLI has a policy flag), on a tiny checkpoint with 30 s windows and
a byte-level vocab: evaluate with the shipped ``configs/eval_*.args``
(short greedy and beam, sequential, chunked; manifest, model and batch
overridden) gives equal MER / EN-WER / ZH-CER and a byte-equal
``eval_predictions.tsv``; transcribe writes equal txt / srt / vtt / json.
The sequential decodes run the sampling rungs (random weights fail the
logprob threshold), so both samplers are patched to argmax there."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu.decode import longform as jax_longform
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import evaluate as jax_eval
from taiwan_whisper_tpu.text.tokenizer import bytes_to_unicode
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.audio.io import write_flac, write_wav
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
from taiwan_whisper_tpu_torch.decode import greedy as port_greedy
from taiwan_whisper_tpu_torch.decode import longform as port_longform
from taiwan_whisper_tpu_torch.models.config import DtypePolicy
from taiwan_whisper_tpu_torch.pipeline import evaluate as port_eval
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
# a tiny model with 30 s windows and 64 positions (a 61-token budget), and
# its 448-position twin for evaluate's short mode, which decodes to JAX's
# max_decode_len of 448 and to the port model's 448 positions
TINY_30S = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
                encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
                decoder_attention_heads=4, max_source_positions=1500,
                max_target_positions=64)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Checkpoints (64 and 448 positions), a byte-level vocab, 2 short
    utterances with reference txts (a test manifest) and 2 lectures of 35
    and 20 s."""
    d = tmp_path_factory.mktemp("torch_eval")
    for name, positions in (("model", 64), ("model448", 448)):
        jcfg = JaxConfig(**dict(TINY_30S, max_target_positions=positions))
        jax_save(str(d / name), jax_init_params(jcfg, seed=0), jcfg)
    (d / "tok").mkdir()
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
    (d / "tok" / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "tok" / "merges.txt").write_text("", encoding="utf-8")
    rng = np.random.RandomState(0)
    (d / "test").mkdir()
    for i, ref in enumerate(["你好 hello world", "<|0.00|>測試語音 Whisper 模型<|1.00|>"]):
        write_wav(str(d / "test" / f"u{i}.wav"),
                  (rng.randn(int((2.5 + i) * 16000)) * 0.1).astype(np.float32))
        (d / "test" / f"u{i}.txt").write_text(ref + "\n", encoding="utf-8")
    write_manifest(str(d / "test.tsv"), Manifest(root=str(d / "test"),
                                                 paths=["u0.wav", "u1.wav"]))
    (d / "lectures").mkdir()
    for i, secs in enumerate((35.0, 20.0)):
        write_flac(str(d / "lectures" / f"lec{i}.flac"), synth_lecture(rng, secs))
    return d


@pytest.fixture
def fp32_argmax(monkeypatch):
    """Both packages at the fp32 policy, both samplers argmax."""
    fp32 = JaxPolicy.fp32()
    monkeypatch.setattr(jax_eval.evaluate_manifest, "__defaults__",
                        (jax_eval.EvalConfig(), fp32, None, None))
    monkeypatch.setitem(port_eval.evaluate_manifest.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    for fn in (jax_longform.sequential_decode, jax_longform.chunked_decode):
        monkeypatch.setattr(fn, "__defaults__", (fp32,))
    for fn in (port_longform.sequential_decode, port_longform.chunked_decode):
        monkeypatch.setattr(fn, "__defaults__", (DtypePolicy.fp32(),))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis)
                        .astype(jnp.int32))
    monkeypatch.setattr(port_greedy, "_sample",
                        lambda masked, temperature, generator: torch.argmax(
                            masked / temperature, dim=-1))


def _files(out_dir):
    return {n: open(os.path.join(out_dir, n), "rb").read() for n in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("args_file,extra", [
    ("eval_short.args", []),
    ("eval_short.args", ["--num_beams", "5"]),
    ("eval_longform_sequential.args", []),
    ("eval_longform_chunked.args", []),
], ids=["short", "short_beam5", "sequential", "chunked"])
def test_cli_evaluate_matches_jax_cli(tmp_path, corpus, fp32_argmax, args_file, extra):
    model = corpus / ("model448" if "short" in args_file else "model")
    common = ["evaluate", f"@{os.path.join(CONFIGS, args_file)}", "--manifest",
              str(corpus / "test.tsv"), "--model", str(model), "--tokenizer_dir",
              str(corpus / "tok"), "--batch_size", "2", *extra]
    want = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    got = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("mer", "en_wer", "zh_cer", "n_samples"):
        assert got[key] == want[key], key
    assert got["n_samples"] == 2 and got["mer"] > 0
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


@pytest.mark.parametrize("strategy,fmt", [("chunked", "txt"), ("chunked", "srt"),
                                          ("chunked", "vtt"), ("sequential", "json")])
def test_cli_transcribe_matches_jax_cli(tmp_path, corpus, fp32_argmax, strategy, fmt):
    common = ["transcribe", "--audio", str(corpus / "lectures"), "--model",
              str(corpus / "model"), "--tokenizer_dir", str(corpus / "tok"),
              "--strategy", strategy, "--format", fmt]
    want = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    got = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert list(got.values()) == list(want.values()) and sum(got.values()) > 2
    files = _files(str(tmp_path / "port"))
    assert sorted(files) == [f"lec0.{fmt}", f"lec1.{fmt}"]
    assert files == _files(str(tmp_path / "jax"))


def test_evaluate_speculative_raises(corpus):
    """The speculative mode without an assistant (draft) model raises, as
    the JAX function asserts, before any file is decoded."""
    from taiwan_whisper_tpu_torch.models.io import load_model
    from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer

    params, config = load_model(str(corpus / "model"))
    with pytest.raises(ValueError, match="needs assistant"):
        port_eval.evaluate_manifest(params, config, WhisperTokenizer(),
                                    str(corpus / "test.tsv"),
                                    port_eval.EvalConfig(mode="speculative"), device="cpu")


def test_cli_evaluate_speculative_args_matches_jax_cli(tmp_path, corpus, fp32_argmax):
    """``cli evaluate @configs/eval_speculative.args`` (manifest, model and
    assistant overridden): the 448-position teacher verifies what its
    1-decoder-layer student (``init_student_from_teacher``) drafts, one
    utterance at a time, each model encoding it; at the fp32 policy the
    scores and ``eval_predictions.tsv`` equal the JAX CLI's."""
    from taiwan_whisper_tpu.models.io import load_model as jax_load
    from taiwan_whisper_tpu.models.params import init_student_from_teacher

    jparams, jcfg = jax_load(str(corpus / "model448"))
    student = init_student_from_teacher(jparams, jcfg, 1)
    jax_save(str(tmp_path / "student"), student, jcfg.with_decoder_layers(1))
    common = ["evaluate", f"@{os.path.join(CONFIGS, 'eval_speculative.args')}", "--manifest",
              str(corpus / "test.tsv"), "--model", str(corpus / "model448"), "--assistant",
              str(tmp_path / "student"), "--tokenizer_dir", str(corpus / "tok")]
    want = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    got = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("mer", "en_wer", "zh_cer", "n_samples"):
        assert got[key] == want[key], key
    assert got["n_samples"] == 2 and got["mer"] > 0
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
