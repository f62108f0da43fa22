"""Stage 2b of the port against the JAX package at the fp32 policy on the
CPU, with the same tiny validator (JAX ``init_params`` through
``from_jax_params`` or one HF checkpoint dir): ``validator_transcribe``'s
hyps, ``run_prefilter``'s and ``cli prefilter @configs/
prefilter_base_0.4.args``'s files (``idx_hyp.0.txt``,
``hallucination_result.csv``, the cleaned TSV) byte for byte,
``filter_manifest`` under each filter option, and the shard merge of
``read_hyps_tsv`` with invalid lines."""

import json
import os

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu.audio.manifest import read_manifest as jax_read_manifest
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import prefilter as jax_pf
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, read_manifest, write_manifest
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params
from taiwan_whisper_tpu_torch.pipeline import prefilter as port_pf
from taiwan_whisper_tpu_torch.pipeline.segment import Utterance, segment_audio_file
from taiwan_whisper_tpu_torch.text.hallucination import clean_segment_transcript
from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer, bytes_to_unicode
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
# a 448-position decoder: the shipped args run the validator's full budget
TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
            encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, max_source_positions=60,
            max_target_positions=448)
ARGS_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "prefilter_base_0.4.args")
TEXT = ["今天", "我們", "來", "討論", "語音", "模型", "hello", "world", "的", "測試", "，"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seven FLAC segments with their 2-line txts (from the port's
    segmenter over a seeded lecture), a byte-level vocab, and the tiny
    validator as JAX params, port params and an HF checkpoint dir."""
    d = tmp_path_factory.mktemp("prefilter")
    rng = np.random.RandomState(0)
    t = np.arange(240 * SR) / SR
    audio = (rng.randn(len(t)) * 0.3 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
             ).astype(np.float32)
    utts, s = [], 0.0
    while s < 235.0:
        e = s + float(rng.uniform(2, 12))
        utts.append(Utterance(round(s, 3), round(e, 3), "".join(rng.choice(TEXT, 5))))
        s = e + float(rng.uniform(0, 1))
    rels = segment_audio_file(audio, utts, str(d / "seg"), "lec")
    assert len(rels) >= 7
    rels = rels[:7]
    manifest = str(d / "train.tsv")
    write_manifest(manifest, Manifest(root=str(d / "seg"), paths=rels))
    tok_dir = d / "tok"
    tok_dir.mkdir()
    (tok_dir / "vocab.json").write_text(
        json.dumps({ch: i for i, ch in enumerate(bytes_to_unicode().values())}),
        encoding="utf-8")
    (tok_dir / "merges.txt").write_text("", encoding="utf-8")
    jcfg = JaxConfig(**TINY)
    jparams = jax_init_params(jcfg, seed=0)
    model_dir = str(d / "validator")
    jax_save(model_dir, jparams, jcfg)
    return dict(dir=d, manifest=manifest, tok_dir=str(tok_dir), model_dir=model_dir,
                jparams=jparams, jcfg=jcfg, params=from_jax_params(jparams, jcfg),
                cfg=WhisperConfig(**TINY))


@pytest.fixture
def fp32_defaults(monkeypatch):
    """Neither prefilter CLI has a policy flag: set each package's default
    policy to fp32."""
    monkeypatch.setattr(jax_pf.validator_transcribe, "__defaults__",
                        (jax_pf.PrefilterConfig(), JaxPolicy.fp32()))
    monkeypatch.setitem(port_pf.run_prefilter.__kwdefaults__, "policy", DtypePolicy.fp32())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_validator_transcribe_matches_jax(setup):
    """Batch 4 over 7 segments: one full batch and one with a zero-audio pad
    row; the hyps (byte-level text of the sampled tokens) must be equal."""
    paths = read_manifest(setup["manifest"]).absolute_paths()
    tok = WhisperTokenizer.from_pretrained_dir(setup["tok_dir"])
    ref = jax_pf.validator_transcribe(
        setup["jparams"], setup["jcfg"], JaxTokenizer.from_pretrained_dir(setup["tok_dir"]),
        paths, jax_pf.PrefilterConfig(batch_size=4, max_decode_len=24), JaxPolicy.fp32())
    stats = {}
    got = port_pf.validator_transcribe(
        setup["params"], setup["cfg"], tok, paths,
        port_pf.PrefilterConfig(batch_size=4, max_decode_len=24), DtypePolicy.fp32(),
        device="cpu", stats=stats)
    assert got == ref
    assert [i for i, _ in got] == list(range(7))
    assert (stats["batches"], stats["pad_rows"], stats["steps"]) == (2, 1, 21)
    rows = port_pf.validator_decode(
        setup["params"], setup["cfg"], tok, paths[:2],
        port_pf.PrefilterConfig(batch_size=4, max_decode_len=24), DtypePolicy.fp32(),
        device="cpu")
    assert [r.shape for _, r, _ in rows] == [(21,), (21,)]
    assert sum(n for _, _, n in rows) > 0  # tokens were sampled


@pytest.mark.parametrize("threshold", [0.4, 1e6], ids=["threshold_0.4", "keep_all"])
def test_run_prefilter_matches_jax(tmp_path, setup, fp32_defaults, threshold):
    outs = {}
    for name, mod, kw in (("jax", jax_pf, {}), ("port", port_pf, dict(device="cpu"))):
        out = str(tmp_path / name)
        cleaned = mod.run_prefilter(
            setup["manifest"], setup["model_dir"], out,
            mod.PrefilterConfig(batch_size=4, max_decode_len=24, threshold=threshold),
            tokenizer_dir=setup["tok_dir"], **kw)
        outs[name] = (cleaned.paths, {n: _read(os.path.join(out, n)) for n in os.listdir(out)})
    assert set(outs["port"][1]) == {"idx_hyp.0.txt", "hallucination_result.csv",
                                    f"train_non-hallucinated-threshold{threshold}.tsv"}
    assert outs["port"] == outs["jax"]
    kept = len(outs["port"][0])
    assert kept == 7 if threshold == 1e6 else kept < 7


def test_cli_prefilter_shipped_args_matches_jax_cli(tmp_path, setup, fp32_defaults):
    """``cli prefilter @configs/prefilter_base_0.4.args`` (batch 64, threshold
    0.4, zh, the 448-token budget) with the tiny validator, overridden paths
    and ``--device cpu``: the same files as the JAX CLI's, byte for byte."""
    common = ["prefilter", f"@{ARGS_FILE}", "--manifest", setup["manifest"],
              "--validator", setup["model_dir"], "--tokenizer_dir", setup["tok_dir"]]
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    stats = port_cli.main(common + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert (stats["batches"], stats["pad_rows"], stats["steps"]) == (1, 57, 445)
    assert stats["device"] == "cpu" and stats["decisions"] == 7
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["hallucination_result.csv", "idx_hyp.0.txt",
                     "train_non-hallucinated-threshold0.4.tsv"]
    for n in names:
        assert _read(tmp_path / "port" / n) == _read(tmp_path / "jax" / n), n


def _hyps(setup):
    """Hyps for the filter: the teacher's own text, a near copy, text of
    another segment, an empty hyp, a repeated n-gram; index 5 left out."""
    m = read_manifest(setup["manifest"])
    teacher = []
    for p in m.transcript_paths():
        with open(p, encoding="utf-8") as f:
            teacher.append(f.readline())
    plain = [clean_segment_transcript(t) for t in teacher]
    return {0: plain[0], 1: plain[1][:-3] + "hello", 2: plain[3], 3: "",
            4: "對對對對對對" * 8, 6: " " + plain[6].upper() + " "}


@pytest.mark.parametrize("kw", [
    dict(), dict(threshold=0.05), dict(mix_detection=True),
    dict(mix_detection=True, threshold=10.0), dict(empty_error_rate=0.0),
], ids=["default", "threshold_0.05", "mix_detection", "mix_detection_10", "empty_rate_0"])
def test_filter_manifest_matches_jax(tmp_path, setup, kw):
    """The filter alone, on a manifest with frame counts, under each option:
    decisions, cleaned manifest and both files equal."""
    m = read_manifest(setup["manifest"])
    frames = list(range(100, 100 + len(m)))
    hyps = _hyps(setup)
    out = {}
    for name, mod, man in (
            ("jax", jax_pf, jax_read_manifest(setup["manifest"])),
            ("port", port_pf, read_manifest(setup["manifest"]))):
        man.frames = frames
        cleaned, decisions = mod.filter_manifest(man, hyps, mod.PrefilterConfig(**kw),
                                                 str(tmp_path / name))
        files = {n: _read(tmp_path / name / n) for n in sorted(os.listdir(tmp_path / name))}
        out[name] = (cleaned.paths, cleaned.frames,
                     [(d.index, d.hallucinated, d.mer, d.reason) for d in decisions], files)
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) == 6  # index 5 has no hyp
    if not kw:
        assert 0 < len(out["port"][0]) < 6


def test_read_hyps_tsv_merges_shards_as_jax(tmp_path, capsys):
    """Shards written by both packages' ``write_hyps_tsv`` (a tab inside a
    hyp becomes a space; a newline inside one splits its line) plus hand
    -made invalid lines: the merged dicts and the printed invalid count are
    equal, and so are the written bytes."""
    hyps = [(0, "plain"), (3, "a\tb"), (1, "two\nlines"), (7, ""), (2, "後")]
    for name, mod in (("jax", jax_pf), ("port", port_pf)):
        mod.write_hyps_tsv(str(tmp_path / name / "idx_hyp.0.txt"), hyps)
    assert _read(tmp_path / "jax" / "idx_hyp.0.txt") == _read(tmp_path / "port" / "idx_hyp.0.txt")
    (tmp_path / "port" / "idx_hyp.1.txt").write_text(
        "5\tfrom rank 1\nx\tnot an index\n3\toverrides\nno tab\n6\ta\tb\n",
        encoding="utf-8")
    shards = [str(tmp_path / "port" / f"idx_hyp.{r}.txt") for r in (0, 1)]
    capsys.readouterr()
    ref = jax_pf.read_hyps_tsv(shards)
    ref_out = capsys.readouterr().out
    got = port_pf.read_hyps_tsv(shards)
    assert got == ref and capsys.readouterr().out == ref_out
    assert got == {0: "plain", 1: "two", 2: "後", 3: "overrides", 5: "from rank 1", 7: ""}
    assert "invalid hyp lines skipped: 4" in ref_out


def test_cli_prefilter_defaults_to_cuda_and_refuses_distributed(monkeypatch, setup, tmp_path):
    """Without CUDA the default device raises; ``--distributed`` (ported:
    tests/test_torch_multiprocess.py) without a launcher's environment
    raises naming the first variable missing. Neither writes anything."""
    argv = ["prefilter", "--manifest", setup["manifest"], "--validator", setup["model_dir"],
            "--output_dir", str(tmp_path / "o")]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE is not set"):
        port_cli.main(argv + ["--distributed", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(argv)
    assert not os.path.exists(tmp_path / "o")
