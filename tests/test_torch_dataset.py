"""The port's tokenizer encode side and training batches against the JAX
package: transcript ids on zh/en text with timestamp and <|continued|>
markers, and ``train_batches`` arrays byte for byte (same RandomState
draws in the same order) over a WAV segment manifest with both txt
schemas."""

import json

import numpy as np
import pytest
import regex

from taiwan_whisper_tpu.audio.io import write_wav
from taiwan_whisper_tpu.audio.manifest import Manifest as JaxManifest
from taiwan_whisper_tpu.pipeline import dataset as JD
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu.text.tokenizer import bytes_to_unicode
from taiwan_whisper_tpu.text.tokenizer import encode_transcript as jax_encode
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, read_segment_txt
from taiwan_whisper_tpu_torch.pipeline import dataset as TD
from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer, encode_transcript, pretokenize

TEXTS = [
    "<|0.00|>你好 hello world<|1.20|><|1.40|>這是測試, it's fine!<|2.50|>",
    "<|0.00|>今天天氣很好<|3.00|><|3.20|>we'll  see   tomorrow 123<|5.00|><|continued|>",
    "plain text, no markers at all 中英 mixed",
    "<|startoftranscript|><|zh|><|transcribe|><|0.00|>帶前綴<|1.00|><|endoftext|>",
    "<|startofprev|><|0.00|>previous 上一段<|2.00|>",
    "<|bogus|> unknown marker <|7.777|> and <|unclosed",
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A byte-level vocab plus a few merges, so BPE merging runs too."""
    d = tmp_path_factory.mktemp("tok")
    byte = list(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(byte)}
    merges = [("h", "e"), ("he", "l"), ("Ġ", "w"), ("l", "l"), ("Ġw", "o")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    return str(d)


def test_pretokenize_matches_gpt2_regex():
    pat = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    cases = TEXTS + ["  two  spaces ", "I'm it's we'll 're", "你好，世界！１２３ abc",
                     " \t\n x", "a　b  \n\n", "!'s ''x", "x  ", " ", "", "3.14 π²",
                     "'", "'ll", "a\x1cb", "end   ", "Ünïcödé ĳ Ⅻ ½"]
    for text in cases:
        assert pretokenize(text) == pat.findall(text), text


@pytest.mark.parametrize("kw", [{}, dict(language="en", predict_timestamps=False),
                                dict(add_special_tokens=False)])
def test_encode_transcript_matches_jax(tok_dir, kw):
    jt, pt = JaxTokenizer.from_pretrained_dir(tok_dir), WhisperTokenizer.from_pretrained_dir(tok_dir)
    for text in TEXTS:
        assert encode_transcript(pt, text, **kw) == jax_encode(jt, text, **kw), text
    assert pt.decode(pt.encode_text("hello world 你好")) == "hello world 你好"


SEGMENTS = [
    # (2-line schema: transcript, prev) or (5-line: transcript, end, prev)
    ("<|0.00|>第一段 hello<|1.00|><|1.20|>more<|2.00|><|endoftext|>", "", None),
    ("<|0.00|>second one<|0.80|><|1.00|>跨越邊界<|2.40|><|continued|><|endoftext|>",
     "<|0.00|>第一段 hello<|1.00|><|endoftext|>", None),
    ("<|0.00|>no timestamps inside text<|endoftext|>",
     "<|0.00|>prev with<|0.50|><|0.60|>continued<|1.00|><|continued|><|endoftext|>", None),
    ("<|0.00|>五行格式<|1.10|><|1.30|>tail part<|2.20|><|continued|><|endoftext|>",
     "<|0.00|>prompt text 很長很長的上一段文字 " + "x" * 40 + "<|1.50|><|endoftext|>",
     "tail part and the rest of it<|2.90|>"),
    ("plain transcript without markers", "plain prompt", "unused end"),
    ("<|0.00|>short<|0.40|><|endoftext|>", "", "end"),
]


@pytest.fixture(scope="module")
def segment_manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("segments")
    rng = np.random.RandomState(0)
    paths = []
    for i, (text, prev, end) in enumerate(SEGMENTS):
        seconds = 1.0 + 0.5 * i
        write_wav(str(d / f"seg{i}.wav"), (rng.randn(int(seconds * 16000)) * 0.1
                                          ).astype(np.float32))
        lines = [text, prev] if end is None else [text, "", end, "", prev]
        (d / f"seg{i}.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
        paths.append(f"seg{i}.wav")
    return str(d), paths


def test_segment_txt_schemas(segment_manifest):
    root, _ = segment_manifest
    two = read_segment_txt(f"{root}/seg1.txt")
    assert two.prev_transcript.startswith("<|0.00|>第一段") and two.end_transcript == ""
    five = read_segment_txt(f"{root}/seg3.txt")
    assert five.end_transcript == SEGMENTS[3][2] and five.prev_transcript == SEGMENTS[3][1]
    assert Manifest(root=root, paths=["a/b.wav"]).transcript_paths() == [f"{root}/a/b.txt"]


@pytest.mark.parametrize("handler", ["trim", "append"])
def test_train_batches_equal_jax(tok_dir, segment_manifest, handler):
    root, paths = segment_manifest
    jt, pt = JaxTokenizer.from_pretrained_dir(tok_dir), WhisperTokenizer.from_pretrained_dir(tok_dir)
    kw = dict(timestamp_probability=0.5, condition_on_prev_probability=0.5,
              max_label_length=40, chunk_samples=60 * 320)
    jcfg, pcfg = JD.TrainPrepConfig(**kw), TD.TrainPrepConfig(**kw)
    manifest = paths * 2  # 12 segments, batches of 4
    for epoch in range(2):
        ref = list(JD.train_batches(JaxManifest(root=root, paths=manifest), jt, jcfg, 4,
                                    seed=7 + epoch, last_segment_handler=handler))
        got = list(TD.train_batches(Manifest(root=root, paths=manifest), pt, pcfg, 4,
                                    seed=7 + epoch, last_segment_handler=handler,
                                    num_workers=2))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert set(g) == set(r) == {"audio", "decoder_input_ids", "labels"}
            for k in r:
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                assert g[k].tobytes() == r[k].tobytes(), k
    # the draws matter: prompts and <|notimestamps|> both occur
    labels = np.concatenate([b["decoder_input_ids"] for b in got])
    assert (labels == pt.special.sot_prev).any() and (labels == pt.special.no_timestamps).any()
