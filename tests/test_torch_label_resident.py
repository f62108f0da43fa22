"""The port's labelling drivers with VAD on the CPU, against the JAX package:
for every (vad_mode, wire_mode) pair the JAX ``label_files`` runs here,
the port's ``label_files`` at the fp32 policy, on the same weights
(``from_jax_params``) and the same audio, must write byte-identical CSVs.
Covers the device-resident driver (auto and resident, VAD spectral or
off, five groups, region packing, the group-boundary rider window,
resume, unreadable files) and the pooled chunk driver with energy,
host-spectral and device-spectral VAD."""

import csv
import os

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.audio.io import write_wav
from taiwan_whisper_tpu.decode.longform import TranscriptSegment as JaxSegment
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import label_resident as JLR
from taiwan_whisper_tpu.pipeline.label import LabelConfig as JaxLabelConfig
from taiwan_whisper_tpu.pipeline.label import label_files as jax_label_files
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu_torch.decode.longform import TranscriptSegment
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params
from taiwan_whisper_tpu_torch.pipeline import label as PL
from taiwan_whisper_tpu_torch.pipeline import label_resident as PLR
from taiwan_whisper_tpu_torch.pipeline.label import LabelConfig, label_files
from taiwan_whisper_tpu_torch.text.tokenizer import WhisperTokenizer
from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture, synth_speech
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
# 1.2 s context (max_source_positions 60) for the many-chunk cases; the
# real 30 s context for packing and the rider window, where VAD regions of
# 12-28 s must fit inside one window
DIMS = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128, encoder_layers=1,
            encoder_attention_heads=4, decoder_attention_heads=4, max_target_positions=48)
TINY = dict(DIMS, decoder_layers=2, max_source_positions=60)
CTX30 = dict(DIMS, decoder_layers=1, max_source_positions=1500)


def _weights(dims):
    jcfg = JaxConfig(**dims)
    jparams = jax_init_params(jcfg, seed=0)
    return jparams, jcfg, from_jax_params(jparams, jcfg), WhisperConfig(**dims)


@pytest.fixture(scope="module")
def tiny():
    return _weights(TINY)


@pytest.fixture(scope="module")
def ctx30():
    return _weights(CTX30)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three lecture-like files (speech bursts between silent gaps) and a
    150 s one that spans two 120 s segments."""
    d = tmp_path_factory.mktemp("torch_resident_corpus")
    rng = np.random.RandomState(11)
    paths = {}
    for name, secs in (("r0", 20.0), ("r1", 35.0), ("r2", 15.0), ("long", 150.0)):
        paths[name] = str(d / f"{name}.wav")
        write_wav(paths[name], synth_lecture(rng, secs))
    return paths


def _read_csvs(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".csv"):
            with open(os.path.join(out_dir, name), "rb") as f:
                out[name] = f.read()
    return out


def _both(weights, paths, out, **kw):
    """Label ``paths`` with both packages at fp32; returns (jax stats,
    port stats, jax CSVs, port CSVs)."""
    jparams, jcfg, params, cfg = weights
    js = jax_label_files(jparams, jcfg, JaxTokenizer(MULTILINGUAL), paths, str(out / "jax"),
                         JaxLabelConfig(**kw), JaxPolicy.fp32(), log_every=0)
    ps = label_files(params, cfg, WhisperTokenizer(MULTILINGUAL), paths, str(out / "port"),
                     LabelConfig(**kw), DtypePolicy.fp32(), device="cpu", log_every=0)
    return js, ps, _read_csvs(out / "jax"), _read_csvs(out / "port")


SHORT = ("r0", "r1", "r2")
CASES = {
    # name: (files, LabelConfig fields, expected port route)
    # the shipped defaults: auto wire mode, spectral VAD, 16-segment groups
    "auto_spectral": (SHORT, dict(vad_mode="spectral"), "resident"),
    "resident_vad_off": (SHORT, dict(wire_mode="resident", vad_mode="off",
                                     vad_regions=False), "resident"),
    "chunks_energy": (SHORT, dict(wire_mode="chunks", vad_mode="energy"), "chunks"),
    "chunks_spectral_host": (SHORT, dict(wire_mode="chunks", vad_mode="spectral-host"),
                             "chunks"),
    "chunks_spectral_device": (SHORT, dict(wire_mode="chunks",
                                           vad_mode="spectral-device"), "chunks"),
    "chunks_float32_wire": (SHORT, dict(wire_mode="chunks", vad_mode="energy",
                                        wire_dtype="float32"), "chunks"),
    # one 120 s segment a group: a group per short file, two for the 150 s one
    "resident_five_groups": (SHORT + ("long",), dict(wire_mode="resident",
                                                     vad_mode="spectral-device",
                                                     group_segs=1), "resident"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_label_csvs_match_jax(tmp_path, tiny, corpus, case):
    names, kw, route = CASES[case]
    js, ps, jax_csvs, port_csvs = _both(tiny, [corpus[n] for n in names], tmp_path,
                                        batch_size=4, max_decode_tokens=16, **kw)
    assert ("groups" in ps) == (route == "resident") == ("groups" in js)
    assert ps["files"] == js["files"] == len(names)
    assert ps["chunks"] == js["chunks"] > 0 and ps["batches"] == js["batches"]
    if route == "resident":
        assert ps["groups"] == js["groups"]
    if case == "resident_five_groups":
        assert ps["groups"] == 5
    if "spectral" in kw.get("vad_mode", "") or kw.get("vad_mode") == "energy":
        # the VAD dropped the silent gaps: fewer chunks than VAD off
        vad_off = sum(len(PLR.chunk_spans(len(_audio(corpus[n])), 19200, 3200, 3200))
                      for n in names)
        assert ps["chunks"] < vad_off
    assert set(port_csvs) == {f"{n}.csv" for n in names}
    assert port_csvs == jax_csvs
    assert sum(c.count(b"\n") for c in port_csvs.values()) > len(names)


def _audio(path):
    from taiwan_whisper_tpu_torch.audio.io import load_audio_16k

    return load_audio_16k(path)


def test_resident_with_energy_vad_raises(tmp_path, tiny):
    _, _, params, cfg = tiny
    with pytest.raises(ValueError, match="resident"):
        label_files(params, cfg, WhisperTokenizer(MULTILINGUAL), [], str(tmp_path),
                    LabelConfig(wire_mode="resident", vad_mode="energy"), device="cpu")


def test_region_packing_matches_jax(tmp_path, ctx30):
    """pack_regions shares 30 s windows between short VAD regions: fewer
    chunks than unpacked, CSVs equal to the JAX package's."""
    d = tmp_path / "c"
    d.mkdir()
    rng = np.random.RandomState(31)
    paths = []
    for i in range(2):
        paths.append(str(d / f"p{i}.wav"))
        write_wav(paths[-1], synth_lecture(rng, 60.0))
    base = dict(vad_mode="spectral", batch_size=4, max_decode_tokens=16,
                wire_mode="resident", group_segs=1)
    js, ps, jax_csvs, port_csvs = _both(ctx30, paths, tmp_path / "packed",
                                        pack_regions=True, **base)
    _, pu, _, _ = _both(ctx30, paths, tmp_path / "plain", **base)
    assert ps["files"] == 2 and 0 < ps["chunks"] == js["chunks"] < pu["chunks"]
    assert port_csvs == jax_csvs
    for blob in port_csvs.values():
        rows = list(csv.DictReader(blob.decode("utf-8").splitlines()))
        assert rows and all(-0.01 <= float(r["start"]) <= 61.0 for r in rows)


def test_group_boundary_rider_window(tmp_path, ctx30, monkeypatch):
    """A rider row near the end of group g+1 needs chunk_len samples past
    its start: the zero tail of the virtual stream provides them, so the
    row holds its own speech (never a clamped, earlier window).

    Geometry (one 120 s segment a group, 30 s context): speech at
    [113, 130] s leads the batch in group 0; speech at [223, 237] s is a
    rider in group 1 whose window [223, 253] s passes the groups' end."""
    rng = np.random.RandomState(7)
    audio = np.zeros(240 * SR, np.float32)
    for lo, hi in ((113, 130), (223, 237)):
        audio[lo * SR: hi * SR] = synth_speech(rng, float(hi - lo))
    p = str(tmp_path / "boundary.wav")
    write_wav(p, audio)
    rows = []
    decode_audio = PL.decode_audio

    def spy(params, audio, *a, **kw):
        rows.append(audio.numpy().copy())
        return decode_audio(params, audio, *a, **kw)

    monkeypatch.setattr(PL, "decode_audio", spy)
    js, ps, jax_csvs, port_csvs = _both(ctx30, [p], tmp_path, vad_mode="spectral",
                                        wire_mode="resident", group_segs=1, batch_size=4,
                                        max_decode_tokens=16)
    assert ps["files"] == 1 and ps["groups"] == 2
    assert ps["chunks"] == js["chunks"] == 2 and ps["batches"] == 1
    assert port_csvs == jax_csvs
    for j, row in enumerate(rows[0][: ps["chunks"]]):
        assert float(np.abs(row).max()) > 0.01, f"row {j} is silence"


def test_gather_rows_never_clamps():
    """Row starts inside the virtual stream gather exactly; a start whose
    window would leave it raises instead of being moved."""
    l_stream, chunk_len = 1000, 600
    a = torch.arange(l_stream + PLR._WIN, dtype=torch.int16)
    b = -torch.arange(l_stream + PLR._WIN, dtype=torch.int16)
    virt = torch.cat([a[:l_stream], b, torch.zeros(chunk_len - PLR._WIN, dtype=torch.int16)])
    # the last admissible start: its window ends with the zero tail
    starts, valid = np.array([0, 990, 2 * l_stream]), np.array([600, 20, 1])
    rows = PLR.gather_rows(a, b, starts, valid, chunk_len=chunk_len, l_stream=l_stream)
    for j, (s, v) in enumerate(zip(starts, valid)):
        want = virt[s: s + chunk_len].float() / 32768.0
        want[v:] = 0
        assert torch.equal(rows[j], want)
    with pytest.raises(IndexError):
        PLR.gather_rows(a, b, np.array([2 * l_stream + 1]), np.array([1]),
                        chunk_len=chunk_len, l_stream=l_stream)
    with pytest.raises(IndexError):
        PLR.gather_rows(a, b, np.array([-1]), np.array([1]), chunk_len=chunk_len,
                        l_stream=l_stream)


def test_resident_resume_and_unreadable(tmp_path, tiny, corpus):
    """Existing CSVs are skipped, an unreadable file is counted and
    skipped, and the rest match the JAX package's."""
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"nope")
    paths = [corpus["r0"], corpus["r1"], bad, corpus["r2"]]
    kw = dict(vad_mode="off", batch_size=4, max_decode_tokens=16)  # auto: resident
    js1, ps1, _, _ = _both(tiny, paths[:2], tmp_path, **kw)
    assert ps1["files"] == js1["files"] == 2
    js2, ps2, jax_csvs, port_csvs = _both(tiny, paths, tmp_path, **kw)
    for s in (js2, ps2):
        assert (s["skipped"], s["failed"], s["files"]) == (2, 1, 1)
    assert port_csvs == jax_csvs and len(port_csvs) == 3


@pytest.mark.parametrize("span_len,chunk_len,stride", [
    (100, 40, 5), (40, 40, 5), (41, 40, 5), (1, 40, 5), (1000, 480, 80), (480000, 19200, 3200),
])
def test_chunk_spans_matches_jax(span_len, chunk_len, stride):
    assert PLR.chunk_spans(span_len, chunk_len, stride, stride) == JLR.chunk_spans(
        span_len, chunk_len, stride, stride)


def test_map_packed_segments_matches_jax():
    pieces = [(0.0, 5.0, 10.0), (5.2, 9.2, 40.0), (9.4, 12.0, 77.5)]
    spans = [(0.5, 2.0), (4.0, 5.1), (5.1, 6.0), (6.0, 8.0), (9.3, 9.35), (9.5, 13.0),
             (12.5, 13.0), (0.0, 0.0)]
    got = PLR.map_packed_segments([TranscriptSegment(a, b, [i]) for i, (a, b)
                                   in enumerate(spans)], pieces)
    want = JLR.map_packed_segments([JaxSegment(a, b, [i]) for i, (a, b)
                                    in enumerate(spans)], pieces)
    assert [(s.start, s.end, s.token_ids) for s in got] == [
        (s.start, s.end, s.token_ids) for s in want]
    assert len(got) == 5  # one in a separator, one in the pad, one empty: dropped
