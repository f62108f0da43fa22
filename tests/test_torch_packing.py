"""Speaker packing and batched short-form labelling of the port against the
JAX package at the fp32 policy on the CPU: ``pack_utterances`` on hand-made
and seeded utterance lists, and ``label_packed`` on a tiny model (JAX
``init_params`` through ``from_jax_params``) over several batches with a
short last batch and a CSV flush after every batch: the CSV byte for byte
and the transcripts."""

import json

import numpy as np
import pytest

from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import packing as jax_packing
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params
from taiwan_whisper_tpu_torch.pipeline import packing as port_packing
from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer, bytes_to_unicode
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128, encoder_layers=1,
            decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
            max_source_positions=60, max_target_positions=24)
WORDS = ["今天", "語音", "hello", "world", "模型", "測試"]


def _seeded(seed, n, speakers, lo=4.0, hi=12.0, none_share=0.0):
    """``n`` utterances of ``lo``-``hi`` s of noise, each spoken by one of
    ``speakers`` (a run of the same speaker continues with probability 0.6);
    a ``none_share`` of them have no speaker id."""
    rng = np.random.RandomState(seed)
    utts, spk = [], 0
    for _ in range(n):
        if rng.rand() > 0.6:
            spk = int(rng.randint(speakers))
        sid = None if rng.rand() < none_share else f"spk{spk}"
        audio = (rng.randn(int(rng.uniform(lo, hi) * SR)) * 0.1).astype(np.float32)
        utts.append((audio, " ".join(rng.choice(WORDS, 3)), sid))
    return utts


def _fixed(secs_speakers, text="t"):
    return [(np.zeros(int(s * SR), np.float32), text, spk) for s, spk in secs_speakers]


PACK_CASES = {
    # tests/test_packing_subtitles.py's three cases
    "same_speaker_concatenates": _fixed([(5, "a"), (5, "a"), (5, "a")]),
    "speaker_change_splits_flag0": _fixed([(5, "a"), (5, "b")]),
    "length_split_flag1": _fixed([(20, "a"), (15, "a"), (5, "a")]),
    "one_utterance": _fixed([(7, "a")]),
    "empty": [],
    "exactly_30s_splits": _fixed([(15, "a"), (15, "a"), (10, "b")]),
    "length_split_then_speaker_change": _fixed([(25, "a"), (10, "a"), (3, "b"), (3, "b")]),
    "no_speaker_ids": _fixed([(6, None), (6, None), (25, None)]),
    "empty_texts": _fixed([(4, "a"), (4, "a"), (4, "b")], text=""),
    **{f"seeded_{seed}_{spk}spk": _seeded(seed, 24, spk) for seed, spk in
       ((0, 2), (1, 3), (2, 2))},
    "seeded_with_none_ids": _seeded(3, 16, 3, none_share=0.3),
}


def _as_tuples(packs):
    return [(p.audio, p.text, p.speaker_id, p.condition_on_prev) for p in packs]


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_utterances_matches_jax(case):
    utts = PACK_CASES[case]
    got = _as_tuples(port_packing.pack_utterances(
        [port_packing.Utterance(a, t, s) for a, t, s in utts]))
    ref = _as_tuples(jax_packing.pack_utterances(
        [jax_packing.Utterance(a, t, s) for a, t, s in utts]))
    assert len(got) == len(ref)
    for (ga, *gmeta), (ra, *rmeta) in zip(got, ref):
        assert gmeta == rmeta
        np.testing.assert_array_equal(ga, ra)
    if case == "length_split_flag1":
        assert [m[3] for m in got] == [1, 0] and [len(m[0]) for m in got] == [20 * SR] * 2


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The tiny model as JAX params and port params, a vocab in which every
    text id decodes to bytes, read by each package's tokenizer, and 5 packs
    from a seeded list."""
    d = tmp_path_factory.mktemp("packing")
    chars = list(bytes_to_unicode().values())
    # every text id decodes: the 256 bytes, then byte pairs, up to <|endoftext|>
    vocab = {ch: i for i, ch in enumerate(chars)}
    vocab.update({chars[i // 256] + chars[i % 256]: i
                  for i in range(256, MULTILINGUAL.eot)})
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("", encoding="utf-8")
    jcfg = JaxConfig(**TINY)
    jparams = jax_init_params(jcfg, seed=0)
    utts = _seeded(5, 9, 3, lo=2.0, hi=9.0, none_share=0.2)
    return dict(jparams=jparams, jcfg=jcfg, params=from_jax_params(jparams, jcfg),
                cfg=WhisperConfig(**TINY), jtok=JaxTokenizer.from_pretrained_dir(str(d)),
                tok=WhisperTokenizer.from_pretrained_dir(str(d)), utts=utts)


@pytest.mark.parametrize("timestamps", [True, False], ids=["timestamps", "no_timestamps"])
def test_label_packed_matches_jax(tmp_path, model, monkeypatch, timestamps):
    """Batch 2 over 5 packs (3 batches, one zero-audio pad row in the last),
    a flush after every batch: the CSV byte-equal to JAX's, the transcripts
    equal, and each batch decoded to the model's ``max_target_positions``
    (no ``max_len`` is passed, as in JAX)."""
    utts = model["utts"]
    jpacks = jax_packing.pack_utterances([jax_packing.Utterance(*u) for u in utts])
    packs = port_packing.pack_utterances([port_packing.Utterance(*u) for u in utts])
    assert len(packs) == 5 and {p.speaker_id for p in packs} >= {None}
    kw = dict(language="zh", batch_size=2, timestamps=timestamps, logging_steps=1)
    ref = jax_packing.label_packed(model["jparams"], model["jcfg"], model["jtok"], jpacks,
                                   str(tmp_path / "jax" / "packed.csv"), JaxPolicy.fp32(), **kw)
    budgets, flushes = [], []
    decode = port_packing.decode_audio
    monkeypatch.setattr(port_packing, "decode_audio", lambda *a, **k: budgets.append(
        decode(*a, **k)) or budgets[-1])

    def counting_open(path, mode="r", *a, **k):
        flushes.append(mode)
        return open(path, mode, *a, **k)

    monkeypatch.setattr(port_packing, "open", counting_open, raising=False)
    got = port_packing.label_packed(model["params"], model["cfg"], model["tok"], packs,
                                    str(tmp_path / "port" / "packed.csv"), DtypePolicy.fp32(),
                                    device="cpu", **kw)
    monkeypatch.undo()
    assert got == ref
    assert (tmp_path / "port" / "packed.csv").read_bytes() == \
        (tmp_path / "jax" / "packed.csv").read_bytes()
    assert [r.tokens.shape for r in budgets] == [(2, TINY["max_target_positions"])] * 3
    assert flushes == ["w", "a", "a", "a"]  # one per batch, then the closing flush
    assert all(got)  # every pack decoded to some text


def test_label_packed_no_packs_writes_header_only(tmp_path, model):
    for pkg, params, cfg, tok, kw in (
            (jax_packing, model["jparams"], model["jcfg"], model["jtok"], {}),
            (port_packing, model["params"], model["cfg"], model["tok"], {"device": "cpu"})):
        out = tmp_path / pkg.__name__.split(".")[0] / "packed.csv"
        assert pkg.label_packed(params, cfg, tok, [], str(out), **kw) == []
    assert (tmp_path / "taiwan_whisper_tpu_torch" / "packed.csv").read_bytes() == \
        (tmp_path / "taiwan_whisper_tpu" / "packed.csv").read_bytes() == \
        b"id,condition_on_prev,whisper_transcript,text\r\n"


def test_label_packed_mel_fn_replaces_the_kernel(tmp_path, model, monkeypatch):
    """``mel_fn`` (kept from the JAX signature) takes each padded batch in
    place of the log-mel kernel: the port's plain log-mel through it writes the
    same CSV as the kernel route (the plain version on the CPU)."""
    from taiwan_whisper_tpu_torch.audio.mel import log_mel
    from taiwan_whisper_tpu_torch.decode import longform

    packs = port_packing.pack_utterances([port_packing.Utterance(*u) for u in model["utts"]])[:3]
    shapes = []

    def mel_fn(audio):
        shapes.append(tuple(audio.shape))
        return log_mel(audio, model["cfg"].num_mel_bins)

    out = {}
    for tag, fn in (("kernel", None), ("mel_fn", mel_fn)):
        path = tmp_path / tag / "packed.csv"
        port_packing.label_packed(model["params"], model["cfg"], model["tok"], packs, str(path),
                                  DtypePolicy.fp32(), batch_size=2, mel_fn=fn, device="cpu")
        out[tag] = path.read_bytes()
    assert out["mel_fn"] == out["kernel"]
    assert shapes == [(2, TINY["max_source_positions"] * 2 * 160)] * 2
    monkeypatch.setattr(longform, "log_mel", None)  # the kernel route is not taken
    port_packing.label_packed(model["params"], model["cfg"], model["tok"], packs[:1],
                              str(tmp_path / "again.csv"), DtypePolicy.fp32(), batch_size=2,
                              mel_fn=mel_fn, device="cpu")
