"""The port's text modules (normalizer, zh conversion, MER, hallucination
detectors, tokenizer helpers) against the JAX package's on seeded zh/en
mixed strings: every case must give equal results (strings, ints and
floats compared exactly)."""

import dataclasses
import types

import numpy as np
import pytest

from taiwan_whisper_tpu.text import hallucination as jax_hall
from taiwan_whisper_tpu.text import metrics as jax_metrics
from taiwan_whisper_tpu.text import normalizer as jax_norm
from taiwan_whisper_tpu.text import tokenizer as jax_tok
from taiwan_whisper_tpu.text import zh as jax_zh
from taiwan_whisper_tpu_torch.text import hallucination as port_hall
from taiwan_whisper_tpu_torch.text import metrics as port_metrics
from taiwan_whisper_tpu_torch.text import normalizer as port_norm
from taiwan_whisper_tpu_torch.text import tokenizer as port_tok
from taiwan_whisper_tpu_torch.text import zh as port_zh
from taiwan_whisper_tpu_torch.utils import native

JAX = types.SimpleNamespace(norm=jax_norm, zh=jax_zh, metrics=jax_metrics, hall=jax_hall,
                            tok=jax_tok)
PORT = types.SimpleNamespace(norm=port_norm, zh=port_zh, metrics=port_metrics, hall=port_hall,
                             tok=port_tok)

# traditional characters of the conversion table, simplified ones, and
# characters of the blocklists
ZH = list("們這個語音測試點讚請不吝字幕提供學習電腦萬與東絲兩嚴我你他的是在有人中大小上下天")
EN = ["hello", "world", "the", "Model", "whisper", "Okay.", "org", "Mm.", "test",
      "code-switching", "it's", "GPU", "2024", "ÉCOLE", "café", "org.tw"]
SEP = [" ", " ", "，", "。", "!", "?", "、", "...", "(aside)", "[noise]", "<|0.00|>",
       "<|12.34|>", "<|continued|>", "ＡＢＣ", "\t", "「", "」", "—", "<|endoftext|>", "  "]


def _text(rng: np.random.RandomState) -> str:
    parts = []
    for _ in range(rng.randint(0, 14)):
        r = rng.rand()
        if r < 0.45:
            parts.append("".join(rng.choice(ZH, rng.randint(1, 5))))
        elif r < 0.8:
            parts.append(str(rng.choice(EN)))
        else:
            parts.append(str(rng.choice(SEP)))
    if rng.rand() < 0.25:  # a repeated n-gram: a hallucination's signature
        parts.append(("".join(rng.choice(ZH, 3)) + "ab") * rng.randint(4, 9))
    return "".join(parts)


TEXTS = [_text(np.random.RandomState(s)) for s in range(60)] + ["", " ", "Okay.", "..."]
PAIRS = list(zip(TEXTS[::2], TEXTS[1::2]))


@pytest.fixture(scope="module")
def lexicons(tmp_path_factory):
    """A zh char -> bopomofo TSV (with tone marks, which the metric drops)
    over half of ZH and an en word -> phonemes TSV over half of EN."""
    d = tmp_path_factory.mktemp("lexicons")
    rng = np.random.RandomState(7)
    syms = list("ㄅㄆㄇㄈㄉㄊㄋㄌㄍㄎㄏㄐㄑㄒㄓㄔㄕㄖㄗㄘㄙㄚㄛㄜㄝㄞㄟㄠㄡㄢㄣㄤㄥㄦㄧㄨㄩˊˇˋ˙")
    with open(d / "zh.tsv", "w", encoding="utf-8") as f:
        for ch in ZH[::2]:
            f.write(f"{ch}\t{' '.join(rng.choice(syms, rng.randint(1, 4)))}\n")
        f.write("malformed line\n")
    with open(d / "en.tsv", "w", encoding="utf-8") as f:
        for w in EN[::2]:
            f.write(f"{w}\t{' '.join(rng.choice(list('AEIOUKLMNPST'), rng.randint(1, 5)))}\n")
    return str(d / "zh.tsv"), str(d / "en.tsv")


def _mer(kw, **compute_kw):
    def run(m, lex):
        metric = m.metrics.MixErrorRate(**kw)
        out = [metric.compute([p], [r], **compute_kw) for p, r in PAIRS]
        out.append(metric.compute([p for p, _ in PAIRS], [r for _, r in PAIRS], **compute_kw))
        return [dataclasses.asdict(o) if dataclasses.is_dataclass(o) else o for o in out]
    return run


def _phonemized(m, lex):
    metric = m.metrics.MixErrorRate(phonemize=True, zh_lexicon_path=lex[0], lexicon_path=lex[1])
    return ([metric._phonemized(metric.units(t)) for t in TEXTS]
            + _mer(dict(phonemize=True, zh_lexicon_path=lex[0], lexicon_path=lex[1]),
                   detailed=True)(m, lex))


def _filter(**kw):
    def run(m, lex):
        f = m.hall.CrossModelFilter(**kw)
        return [dataclasses.asdict(d) for d in
                f.check_batch((i, t, h) for i, (t, h) in
                              enumerate(PAIRS + [(t, t) for t in TEXTS]))]
    return run


def _timestamps(m, lex):
    frames = list(np.random.RandomState(3).randint(-2000, 480000, 200)) + [
        160, 480, 800, 319, 320, 321, 0, 479999]
    secs = list(np.random.RandomState(4).rand(100) * 30) + [0.01, 0.03, 29.99, 30.0]
    return ([m.tok.frames_to_timestamp_str(int(n)) for n in frames]
            + [m.tok.seconds_to_timestamp_str(float(s)) for s in secs])


CASES = {
    "normalizer": lambda m, lex: [m.norm.BasicTextNormalizer()(t) for t in TEXTS],
    "normalizer_remove_diacritics": lambda m, lex: [
        m.norm.BasicTextNormalizer(remove_diacritics=True)(t) for t in TEXTS],
    "normalizer_split_letters": lambda m, lex: [
        m.norm.BasicTextNormalizer(split_letters=True)(t) for t in TEXTS],
    "t2s": lambda m, lex: [m.zh.T2SConverter().convert(t) for t in TEXTS],
    "s2t": lambda m, lex: [m.zh.S2TConverter().convert(t) for t in TEXTS],
    "mer_units": lambda m, lex: [m.metrics.MixErrorRate().units(t) for t in TEXTS],
    "mer": _mer({}),
    "mer_traditional": _mer(dict(to_simplified_chinese=False, to_traditional_chinese=True)),
    "mer_no_conversion": _mer(dict(to_simplified_chinese=False)),
    "mer_separate_language": _mer(dict(separate_language=True)),
    "mer_repetitions": _mer(dict(count_repetitive_hallucination=True)),
    "mer_separate_and_repetitions": _mer(dict(separate_language=True,
                                              count_repetitive_hallucination=True)),
    "mer_detailed_sdi": _mer(dict(separate_language=True, count_repetitive_hallucination=True),
                             detailed=True),
    "mer_complete": _mer(dict(calculate_complete_mer=True)),
    "mer_empty_error_rate": _mer({}, empty_error_rate=0.25),
    "mer_phonemize_zh_lexicon": _phonemized,
    "edit_ops": lambda m, lex: [m.metrics.edit_ops(list(r), list(p)) for p, r in PAIRS],
    "count_repetitive_hallucination": lambda m, lex: [
        (m.metrics.count_repetitive_hallucination(t),
         m.metrics.count_repetitive_hallucination(t, n=3, repeat=3, reset_len=20))
        for t in TEXTS],
    "char_ngram_hallucinated": lambda m, lex: [
        (m.hall.char_ngram_hallucinated(t), m.hall.char_ngram_hallucinated(t, n=3, threshold=2))
        for t in TEXTS],
    "blocklist_hits": lambda m, lex: [
        m.hall.blocklist_hits(s) for t in TEXTS for s in (t, m.norm.BasicTextNormalizer()(t))],
    "clean_segment_transcript": lambda m, lex: [
        m.hall.clean_segment_transcript(t) for t in TEXTS],
    "cross_model_filter": _filter(),
    "cross_model_filter_mix_detection": _filter(mix_detection=True),
    "cross_model_filter_threshold_empty_rate": _filter(threshold=1.5, empty_error_rate=0.0),
    "wer_filter_in_range": lambda m, lex: [
        m.hall.wer_filter_in_range(p, r, m.metrics.MixErrorRate(), pct)
        for p, r in PAIRS for pct in (10.0, 50.0, 100.0, 400.0)],
    "strip_markers": lambda m, lex: [m.tok.strip_markers(t) for t in TEXTS]
    + [m.tok.strip_markers(t) for t in ("a<|b", "<|x|>y<|", "|>z<|w|>", "<||>")],
    "timestamp_strings": _timestamps,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_text_matches_jax(case, lexicons):
    got = CASES[case](PORT, lexicons)
    assert got == CASES[case](JAX, lexicons)
    assert len(got) > 0


def test_edit_distance_native_matches_plain():
    """The native edit distance the port's MER runs on against its plain
    version (and the JAX package's), on unit sequences from the corpus and
    on random token lists, empty ones included."""
    metric = port_metrics.MixErrorRate()
    seqs = [metric.units(t) for t in TEXTS] + [[], ["a"]]
    rng = np.random.RandomState(11)
    seqs += [[str(x) for x in rng.randint(0, 6, rng.randint(0, 40))] for _ in range(30)]
    pairs = list(zip(seqs[:-1], seqs[1:])) + [(s, s) for s in seqs[:5]]
    got = [native.edit_distance(a, b) for a, b in pairs]
    assert got == [port_metrics.edit_distance_py(a, b) for a, b in pairs]
    assert got == [jax_metrics.edit_distance_py(a, b) for a, b in pairs]
    assert max(got) > 10


@pytest.mark.parametrize("kw,error", [
    (dict(to_traditional_chinese=True), ValueError),
    (dict(phonemize=True, separate_language=True), NotImplementedError),
], ids=["both_conversions", "phonemize_separate_language"])
def test_mer_refused_options_raise_as_jax(kw, error, lexicons):
    kw = dict(kw, zh_lexicon_path=lexicons[0])
    for m in (JAX, PORT):
        with pytest.raises(error):
            m.metrics.MixErrorRate(**kw)


SRT = ("1\n00:00:01,000 --> 00:00:03,500\n你好 world\n\n"
       "2\n00:00:04,000 --> 00:00:06,000\nsecond line\nwrapped text\n\n\n"
       "3\n0:00:07.250 --> 00:00:09,000\n  跨 model 測試  \n")
VTT = ("WEBVTT\n\n00:00:01.000 --> 00:00:03.000\nhello\n\n"
       "00:04.000 --> 00:06.500\n再見\n\nNOTE x\n\n00:07.000 --> 00:12.000\nlong\n")


@pytest.mark.parametrize("case", ["timecodes", "read_srt", "read_vtt", "cut_cue_pairs",
                                  "writers", "build_test_set"])
def test_subtitles_match_jax(case, tmp_path):
    """text/subtitles.py (a copy of the JAX module): readers, the cue cutter,
    the test-set builder and the srt/vtt writers give the JAX module's
    values and bytes."""
    from taiwan_whisper_tpu.audio.io import write_wav
    from taiwan_whisper_tpu.text import subtitles as jax_sub
    from taiwan_whisper_tpu_torch.text import subtitles as port_sub

    (tmp_path / "a.srt").write_text(SRT, encoding="utf-8")
    (tmp_path / "a.vtt").write_text(VTT, encoding="utf-8")
    audio = np.random.RandomState(0).randn(16000 * 10).astype(np.float32) * 0.1

    def run(mod, out):
        if case == "timecodes":
            return [mod.timecode_to_seconds(t) for t in
                    ("00:01:02.500", "01:02.5", "5.25", "1:00:00,125")]
        if case in ("read_srt", "read_vtt"):
            return [dataclasses.astuple(c) for c in
                    getattr(mod, case)(str(tmp_path / f"a.{case[-3:]}"))]
        cues = [mod.Cue(1.0, 2.0, "a"), mod.Cue(8.0, 12.0, "overruns"),
                mod.Cue(3.0, 2.0, "bad"), mod.Cue(61.25, 3661.004, "跨 model 測試")]
        if case == "cut_cue_pairs":
            return [(a.tolist(), t) for a, t in mod.cut_cue_pairs(audio, cues)]
        out.mkdir()
        if case == "writers":
            mod.write_srt(str(out / "c.srt"), cues)
            mod.write_vtt(str(out / "c.vtt"), cues)
        else:
            write_wav(str(tmp_path / "lec.wav"), audio)
            rels = mod.build_test_set(str(tmp_path / "lec.wav"), str(tmp_path / "a.srt"),
                                      str(out), audio_format="wav")
            assert rels
        return {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*"))
                if p.is_file()}

    assert run(port_sub, tmp_path / "port") == run(jax_sub, tmp_path / "jax")
