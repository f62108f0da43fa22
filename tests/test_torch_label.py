"""The port's labelling slice end to end on the CPU: ``label_files`` and
``cli label`` of taiwan_whisper_tpu_torch against the JAX package's pooled
chunk path (VAD off, fp32 policy, the same weights through
``from_jax_params``) must write byte-identical CSVs; so must the shipped
args as the JAX CLI runs them, greedy, beam (``label_large_v2_beam.args``),
``--strategy sequential`` and ``--no_pooled``."""

import json
import os

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.audio.io import write_wav
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline.label import LabelConfig as JaxLabelConfig
from taiwan_whisper_tpu.pipeline.label import label_files as jax_label_files
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu.text.tokenizer import bytes_to_unicode
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.io import save_hf_checkpoint
from taiwan_whisper_tpu_torch.models.params import from_jax_params
from taiwan_whisper_tpu_torch.pipeline.label import LabelConfig, label_files
from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
            encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, max_source_positions=60,
            max_target_positions=48)


def _burst(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    return (rng.randn(n) * 0.3 * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The WAV corpus of tests/test_label_pooled.py plus a byte-level
    vocabulary, so CSV text is real decoded bytes."""
    d = tmp_path_factory.mktemp("torch_label_corpus")
    rng = np.random.RandomState(0)
    sil = lambda s: np.zeros(int(s * SR), np.float32)  # noqa: E731
    a = np.concatenate([_burst(rng, 2.0), sil(1.2), _burst(rng, 2.5)])
    b = np.concatenate([sil(0.4), _burst(rng, 0.9)])
    c = sil(2.0)
    for name, audio in (("a", a), ("b", b), ("c", c)):
        write_wav(str(d / f"{name}.wav"), audio)
    tok_dir = d / "tok"
    tok_dir.mkdir()
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
    (tok_dir / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tok_dir / "merges.txt").write_text("", encoding="utf-8")
    return d


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**TINY)
    jparams = jax_init_params(jcfg, seed=0)
    return jparams, jcfg, from_jax_params(jparams, jcfg), WhisperConfig(**TINY)


def _read_csvs(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".csv"):
            with open(os.path.join(out_dir, name), "rb") as f:
                out[name] = f.read()
    return out


def test_label_files_csvs_match_jax(tmp_path, corpus, weights):
    jparams, jcfg, params, cfg = weights
    paths = [str(corpus / f"{n}.wav") for n in ("a", "b", "c")]
    tok_dir = str(corpus / "tok")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_label_files(
        jparams, jcfg, JaxTokenizer.from_pretrained_dir(tok_dir), paths, jax_dir,
        JaxLabelConfig(vad_regions=False, vad_mode="off", wire_mode="chunks",
                       batch_size=8, max_decode_tokens=16),
        JaxPolicy.fp32(), log_every=0)
    stats = label_files(
        params, cfg, WhisperTokenizer.from_pretrained_dir(tok_dir), paths, port_dir,
        LabelConfig(vad_mode="off", wire_mode="chunks", batch_size=8, max_decode_tokens=16),
        DtypePolicy.fp32(), device="cpu", log_every=0)
    assert stats["files"] == 3 and stats["chunks"] > 8  # more than one batch
    assert stats["batches"] == -(-stats["chunks"] // 8)
    jax_csvs, port_csvs = _read_csvs(jax_dir), _read_csvs(port_dir)
    assert set(port_csvs) == {"a.csv", "b.csv", "c.csv"}
    assert port_csvs == jax_csvs
    assert port_csvs["a.csv"].count(b"\n") > 1  # segments were decoded


def test_cli_label_matches_label_files(tmp_path, corpus, weights):
    """`label --device cpu` through the port's CLI (bf16 default policy)
    writes what the port's label_files writes from the same checkpoint."""
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest

    _, _, params, cfg = weights
    model_dir = str(tmp_path / "model")
    save_hf_checkpoint(model_dir, params, cfg)
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, Manifest(root=str(corpus), paths=["a.wav", "b.wav"]))
    tok_dir = str(corpus / "tok")
    cli_dir, lib_dir = str(tmp_path / "cli"), str(tmp_path / "lib")
    stats = port_cli.main([
        "label", "--manifest", manifest, "--model", model_dir, "--output_dir", cli_dir,
        "--batch_size", "8", "--vad_mode", "off", "--quantize_kv", "fp8",
        "--max_decode_tokens", "16", "--tokenizer_dir", tok_dir, "--device", "cpu"])
    assert stats["files"] == 2 and stats["device"] == "cpu"
    label_files(params, cfg, WhisperTokenizer.from_pretrained_dir(tok_dir),
                [str(corpus / "a.wav"), str(corpus / "b.wav")], lib_dir,
                LabelConfig(vad_mode="off", batch_size=8, max_decode_tokens=16,
                            quantize_kv="fp8"),
                device="cpu", log_every=0)
    assert _read_csvs(cli_dir) == _read_csvs(lib_dir)


@pytest.mark.parametrize("kw", [dict(strategy="greedy"), dict(wire_dtype="int8")])
def test_unported_label_options_raise(tmp_path, weights, kw):
    """Options the port does not take raise before any file is read (int4
    and "8x8" cross-KV, which raised here until they were ported, run in
    test_cli_label_quantize_int4_matches_jax_cli and tests/test_torch_quant.py)."""
    _, _, params, cfg = weights
    with pytest.raises(ValueError):
        label_files(params, cfg, WhisperTokenizer(), [], str(tmp_path),
                    LabelConfig(**kw), device="cpu")


@pytest.mark.parametrize("flag", [["--distributed"], ["--distributed", "--assistant", "draft"]])
def test_cli_label_refuses_unported_flags(tmp_path, flag, monkeypatch):
    """``--distributed`` (ported: tests/test_torch_multiprocess.py) without
    a launcher's environment raises, naming the first variable missing,
    before any file is read, with or without ``--assistant`` (ported: see
    test_cli_label_assistant_matches_jax_cli)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        port_cli.main(["label", "--manifest", str(tmp_path / "none.tsv"),
                       "--model", str(tmp_path / "none"), "--output_dir", str(tmp_path),
                       "--device", "cpu"] + flag)
    assert os.listdir(tmp_path) == []


def test_cli_label_shipped_args_matches_jax_cli(tmp_path, corpus, weights, monkeypatch):
    """``cli label @configs/label_large_v2.args`` (b32, fp8 cross-KV, zh,
    chunked, and so spectral VAD and the auto wire mode by default) with a
    tiny checkpoint, FLAC input and ``--device cpu``: the port's CLI takes
    the resident route and, both CLIs at the fp32 policy, writes the JAX
    CLI's CSVs byte for byte (neither label CLI has a policy flag, so each
    package's default policy is set to fp32 here)."""
    from taiwan_whisper_tpu import cli as jax_cli
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.pipeline import label as jax_label
    from taiwan_whisper_tpu_torch.pipeline import label as port_label
    from taiwan_whisper_tpu_torch.audio.io import write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture

    jparams, jcfg, _, _ = weights
    model_dir = str(tmp_path / "model")
    jax_save(model_dir, jparams, jcfg)
    audio_dir = tmp_path / "flac"
    audio_dir.mkdir()
    rng = np.random.RandomState(3)
    names = []
    for i, secs in enumerate((18.0, 26.0)):
        names.append(f"f{i}.flac")
        write_flac(str(audio_dir / names[-1]), synth_lecture(rng, secs))
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, Manifest(root=str(audio_dir), paths=names))
    args_file = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "configs", "label_large_v2.args")
    common = ["label", f"@{args_file}", "--manifest", manifest, "--model", model_dir,
              "--tokenizer_dir", str(corpus / "tok")]
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (JaxLabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_label.run_labelling.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    jax_stats = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "groups" in stats and "groups" in jax_stats  # the resident route
    assert stats["files"] == jax_stats["files"] == 2 and stats["device"] == "cpu"
    assert stats["chunks"] == jax_stats["chunks"] > 0
    port_csvs = _read_csvs(str(tmp_path / "port"))
    assert set(port_csvs) == {"f0.csv", "f1.csv"}
    assert port_csvs == _read_csvs(str(tmp_path / "jax"))


def test_cli_label_validation_manifest_matches_jax_cli(tmp_path, corpus, weights, monkeypatch):
    """``cli label --validation_manifest``: the labelled split goes through
    the same labelling path into ``validation/`` and is scored against its
    transcript txts; at the fp32 policy the port's validation CSVs and
    stats (MER, EN-WER, ZH-CER, file count) equal the JAX CLI's. One split
    file has no txt and is left out of the score, as in JAX."""
    from taiwan_whisper_tpu import cli as jax_cli
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.pipeline import label as jax_label
    from taiwan_whisper_tpu_torch.audio.io import write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.pipeline import label as port_label

    jparams, jcfg, _, _ = weights
    model_dir = str(tmp_path / "model")
    jax_save(model_dir, jparams, jcfg)
    val_dir = tmp_path / "val"
    val_dir.mkdir()
    rng = np.random.RandomState(1)
    refs = ["<|0.00|>你好 hello world<|1.00|><|endoftext|>", "測試語音 Whisper 模型",
            None]
    for i, ref in enumerate(refs):
        write_flac(str(val_dir / f"v{i}.flac"), _burst(rng, 1.5 + i))
        if ref is not None:
            (val_dir / f"v{i}.txt").write_text(ref + "\nprev\n", encoding="utf-8")
    val_manifest = str(tmp_path / "valid.tsv")
    write_manifest(val_manifest, Manifest(root=str(val_dir),
                                          paths=[f"v{i}.flac" for i in range(3)]))
    manifest = str(tmp_path / "train.tsv")
    write_manifest(manifest, Manifest(root=str(corpus), paths=["a.wav", "b.wav"]))
    common = ["label", "--manifest", manifest, "--model", model_dir, "--batch_size", "4",
              "--vad_mode", "off", "--max_decode_tokens", "16",
              "--tokenizer_dir", str(corpus / "tok"), "--validation_manifest", val_manifest]
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (JaxLabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_label.run_labelling.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    jax_stats = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["validation"] == jax_stats["validation"]
    assert stats["validation"]["n_files"] == 2 and stats["validation"]["mer"] > 0
    assert stats["files"] == 2
    for sub in ("", "validation"):
        got = _read_csvs(str(tmp_path / "port" / sub))
        assert got == _read_csvs(str(tmp_path / "jax" / sub))
        assert len(got) == (3 if sub else 2)


@pytest.mark.parametrize("args_file,extra", [
    ("label_large_v2_beam.args", []),
    ("label_large_v2.args", ["--strategy", "sequential"]),
    ("label_large_v2.args", ["--no_pooled"]),
], ids=["beam_args", "sequential", "no_pooled"])
def test_cli_label_long_form_routes_match_jax_cli(tmp_path, corpus, monkeypatch, args_file,
                                                  extra):
    """``cli label @configs/label_large_v2_beam.args`` (beam 5, int8 cross-KV,
    b8: the resident route with beam search), and the shipped args with
    ``--strategy sequential`` or ``--no_pooled`` (file by file over the
    spectral VAD's regions), on FLAC lectures with a tiny checkpoint of
    30 s windows: at the fp32 policy the port writes the JAX CLI's CSVs.
    Random weights fail the logprob threshold, so the sequential ladder
    samples: both samplers are patched to argmax."""
    import jax
    import jax.numpy as jnp

    from taiwan_whisper_tpu import cli as jax_cli
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.pipeline import label as jax_label
    from taiwan_whisper_tpu_torch.audio.io import write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.decode import greedy as port_greedy
    from taiwan_whisper_tpu_torch.pipeline import label as port_label
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture

    jcfg = JaxConfig(**dict(TINY, max_source_positions=1500, max_target_positions=40))
    model_dir = str(tmp_path / "model")
    jax_save(model_dir, jax_init_params(jcfg, seed=0), jcfg)
    audio_dir = tmp_path / "flac"
    audio_dir.mkdir()
    rng = np.random.RandomState(3)
    names = []
    for i, secs in enumerate((12.0, 20.0)):
        names.append(f"f{i}.flac")
        write_flac(str(audio_dir / names[-1]), synth_lecture(rng, secs))
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, Manifest(root=str(audio_dir), paths=names))
    args = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", args_file)
    common = ["label", f"@{args}", "--manifest", manifest, "--model", model_dir,
              "--tokenizer_dir", str(corpus / "tok"), *extra]
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (JaxLabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_label.run_labelling.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis)
                        .astype(jnp.int32))
    monkeypatch.setattr(port_greedy, "_sample",
                        lambda masked, temperature, generator: torch.argmax(
                            masked / temperature, dim=-1))
    jax_stats = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["files"] == jax_stats["files"] == 2 and stats["device"] == "cpu"
    assert ("groups" in stats) == (args_file == "label_large_v2_beam.args")  # resident route
    port_csvs = _read_csvs(str(tmp_path / "port"))
    assert set(port_csvs) == {"f0.csv", "f1.csv"}
    assert all(csv.count(b"\n") > 2 for csv in port_csvs.values())  # segments were decoded
    assert port_csvs == _read_csvs(str(tmp_path / "jax"))


def test_cli_label_quantize_int4_matches_jax_cli(tmp_path, corpus, weights, monkeypatch):
    """``cli label --quantize_kv 4`` (VAD off, the chunk route): int4 cross
    K/V packed two positions a byte in the port, jnp.int4 in JAX; at the
    fp32 policy the CSVs are equal."""
    from taiwan_whisper_tpu import cli as jax_cli
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.pipeline import label as jax_label
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.pipeline import label as port_label

    jparams, jcfg, _, _ = weights
    model_dir = str(tmp_path / "model")
    jax_save(model_dir, jparams, jcfg)
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, Manifest(root=str(corpus), paths=["a.wav", "b.wav"]))
    common = ["label", "--manifest", manifest, "--model", model_dir, "--batch_size", "8",
              "--vad_mode", "off", "--wire_mode", "chunks", "--quantize_kv", "4",
              "--max_decode_tokens", "16", "--tokenizer_dir", str(corpus / "tok")]
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (JaxLabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_label.run_labelling.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    jax_stats = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["files"] == jax_stats["files"] == 2 and stats["chunks"] == jax_stats["chunks"]
    port_csvs = _read_csvs(str(tmp_path / "port"))
    assert port_csvs["a.csv"].count(b"\n") > 1
    assert port_csvs == _read_csvs(str(tmp_path / "jax"))


@pytest.mark.parametrize("encoder", ["shared", "separate"])
def test_cli_label_assistant_matches_jax_cli(tmp_path, corpus, monkeypatch, encoder):
    """``cli label @configs/label_large_v2.args --assistant DIR`` on a FLAC
    lecture with a tiny checkpoint of 30 s windows: speculative decoding
    one strided window at a time, the draft model either the teacher's
    1-decoder-layer student (``init_student_from_teacher``: the encoder is
    shared) or a random model with a 2-layer encoder of its own. VAD off
    (one span a file: the JAX route compiles once a span). At the fp32
    policy the port writes the JAX CLI's CSVs; its stats carry the mean
    draft accept rate."""
    from taiwan_whisper_tpu import cli as jax_cli
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.models.params import init_student_from_teacher
    from taiwan_whisper_tpu.pipeline import label as jax_label
    from taiwan_whisper_tpu_torch.audio.io import write_flac
    from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
    from taiwan_whisper_tpu_torch.pipeline import label as port_label
    from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture

    jcfg = JaxConfig(**dict(TINY, max_source_positions=1500, max_target_positions=40))
    jparams = jax_init_params(jcfg, seed=0)
    model_dir, draft_dir = str(tmp_path / "model"), str(tmp_path / "draft")
    jax_save(model_dir, jparams, jcfg)
    if encoder == "shared":
        jax_save(draft_dir, init_student_from_teacher(jparams, jcfg, 1),
                 jcfg.with_decoder_layers(1))
    else:
        dcfg = JaxConfig(**dict(TINY, max_source_positions=1500, max_target_positions=40,
                                encoder_layers=2, decoder_layers=1))
        jax_save(draft_dir, jax_init_params(dcfg, seed=7), dcfg)
    audio_dir = tmp_path / "flac"
    audio_dir.mkdir()
    write_flac(str(audio_dir / "f0.flac"), synth_lecture(np.random.RandomState(3), 40.0))
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, Manifest(root=str(audio_dir), paths=["f0.flac"]))
    args = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "label_large_v2.args")
    common = ["label", f"@{args}", "--manifest", manifest, "--model", model_dir,
              "--assistant", draft_dir, "--num_draft_tokens", "4", "--vad_mode", "off",
              "--tokenizer_dir", str(corpus / "tok")]
    monkeypatch.setattr(jax_label.label_files, "__defaults__",
                        (JaxLabelConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_label.run_labelling.__kwdefaults__, "policy",
                        DtypePolicy.fp32())
    jax_stats = jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert stats["files"] == jax_stats["files"] == 1 and stats["spec_windows"] == 2
    assert 0.0 <= stats["draft_accept_rate"] <= 1.0 and stats["spec_rounds"] >= 2
    port_csvs = _read_csvs(str(tmp_path / "port"))
    assert port_csvs["f0.csv"].count(b"\n") > 2  # segments were decoded
    assert port_csvs == _read_csvs(str(tmp_path / "jax"))
