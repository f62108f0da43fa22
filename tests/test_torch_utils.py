"""The port's host utilities against the JAX package's: corpus ingest
(``convert_to_flac_16k`` from WAV and FLAC, the error without ffmpeg,
``batch_convert`` with ``duration_stats``), corpus bookkeeping (the cases
of tests/test_corpus.py), the profiling hooks (``device_time``
on the CPU, ``trace`` writing a Chrome trace; the spans and counters are
in test_torch_tracing.py), the figure
panels, and ``push_to_hub`` through a stub ``huggingface_hub`` (never the
network)."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.audio import corpus as jax_corpus
from taiwan_whisper_tpu.audio import ingest as jax_ingest
from taiwan_whisper_tpu.audio.io import load_audio_16k as jax_load
from taiwan_whisper_tpu_torch.audio import corpus as port_corpus
from taiwan_whisper_tpu_torch.audio import ingest as port_ingest
from taiwan_whisper_tpu_torch.audio.io import load_audio_16k, write_flac, write_wav
from taiwan_whisper_tpu_torch.utils import figures, hub, profiling

SR = 16000


def _audio(seconds, seed):
    return (np.random.RandomState(seed).randn(int(seconds * SR)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("ext,rate", [(".wav", 16000), (".wav", 8000), (".flac", 16000)])
def test_convert_to_flac_matches_jax(tmp_path, ext, rate):
    src = str(tmp_path / f"a{ext}")
    (write_wav if ext == ".wav" else write_flac)(src, _audio(1.3, 0), rate)
    got = port_ingest.convert_to_flac_16k(src, str(tmp_path / "port" / "a.flac"))
    ref = jax_ingest.convert_to_flac_16k(src, str(tmp_path / "jax" / "a.flac"))
    assert got == str(tmp_path / "port" / "a.flac")
    with open(got, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(load_audio_16k(got), jax_load(ref))
    assert len(load_audio_16k(got)) == int(1.3 * SR) * 16000 // rate


def test_convert_deletes_the_original_when_asked(tmp_path):
    src = str(tmp_path / "a.wav")
    write_wav(src, _audio(0.5, 1))
    port_ingest.convert_to_flac_16k(src, str(tmp_path / "a.flac"), delete_original=True)
    assert not os.path.exists(src) and os.path.exists(tmp_path / "a.flac")


@pytest.mark.parametrize("ext", [".webm", ".m4a", ".mp3", ".xyz"])
def test_convert_errors_match_jax(tmp_path, monkeypatch, ext):
    """Without ffmpeg the ffmpeg formats raise the JAX package's message; an
    unknown format raises ValueError in both."""
    monkeypatch.setattr(port_ingest.shutil, "which", lambda name: None)
    monkeypatch.setattr(jax_ingest.shutil, "which", lambda name: None)
    src = str(tmp_path / f"a{ext}")
    with open(src, "wb") as f:
        f.write(b"\x00")
    errors = []
    for mod in (port_ingest, jax_ingest):
        assert not mod.ffmpeg_available()
        with pytest.raises((RuntimeError, ValueError)) as e:
            mod.convert_to_flac_16k(src, str(tmp_path / "a.flac"))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is (ValueError if ext == ".xyz" else RuntimeError)


def test_batch_convert_and_duration_stats_match_jax(tmp_path, capsys):
    srcs = []
    for i in range(3):
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, _audio(i + 1, i))
        srcs.append(p)
    bad = str(tmp_path / "bad.webm")
    with open(bad, "wb") as f:
        f.write(b"\x00")
    srcs.append(bad)
    res = {}
    for tag, mod in (("port", port_ingest), ("jax", jax_ingest)):
        out = str(tmp_path / tag)
        pairs = mod.batch_convert(srcs, out, num_workers=2)
        stats = mod.duration_stats([d for _, d in pairs if d] + [bad])
        res[tag] = ([(s, d and os.path.relpath(d, out)) for s, d in pairs],
                    dataclasses.asdict(stats), stats.total_hours)
    assert res["port"] == res["jax"]
    pairs, stats, hours = res["port"]
    assert [d for _, d in pairs] == ["0.flac", "1.flac", "2.flac", None]
    assert stats["n_files"] == 3 and stats["total_seconds"] == pytest.approx(6.0)
    assert (stats["min_seconds"], stats["max_seconds"]) == (1.0, 3.0)
    assert hours == pytest.approx(6.0 / 3600)
    assert dataclasses.asdict(port_ingest.duration_stats([])) == \
        dataclasses.asdict(jax_ingest.duration_stats([]))
    assert "[ingest] failed" in capsys.readouterr().out


SIDS = ["x:901_123:y", "x:901_123", "901_123", None, "A01_x", "901", "x_1_2", "W01_1", "",
        "K12_3", "z:Q01_9:z:w", "_1"]


@pytest.mark.parametrize("sid", SIDS)
def test_sid_functions_match_jax(sid):
    for fn in ("normalize_sid", "is_valid_sid", "sid_category"):
        assert getattr(port_corpus, fn)(sid) == getattr(jax_corpus, fn)(sid), fn
    norm = port_corpus.normalize_sid(sid)
    assert port_corpus.sid_category(norm) == jax_corpus.sid_category(norm)


def test_corpus_tables_match_jax():
    assert port_corpus.FACULTY_CODES == jax_corpus.FACULTY_CODES
    assert port_corpus.category_names() == jax_corpus.category_names()
    assert port_corpus.UNKNOWN == jax_corpus.UNKNOWN


@pytest.mark.parametrize("move", [False, True], ids=["layout_only", "move"])
def test_categorize_and_distribution_match_jax(tmp_path, move):
    """tests/test_corpus.py's corpus on both packages, each on its own copy
    of the files: the mappings, the layout, the moves, the seconds per
    bucket and the TSV."""
    csv_path = tmp_path / "vid_cid_sid.csv"
    csv_path.write_text("vid,cid,sid\nlec1,c1,x:901_123:y\nlec2,c2,101_007\nlec3,c3,zzz\n"
                        "broken,row\n")
    names_path = tmp_path / "names.csv"
    names_path.write_text("sid,name\n901_123,Signals\n101_007,Poetry\nshort\n")
    assert port_corpus.read_vid_to_sid(str(csv_path)) == jax_corpus.read_vid_to_sid(
        str(csv_path)) == {"lec1": "901_123", "lec2": "101_007", "lec3": "zzz"}
    assert port_corpus.read_vid_to_sid(str(csv_path), normalized=False) == \
        jax_corpus.read_vid_to_sid(str(csv_path), normalized=False)
    assert port_corpus.read_sid_to_course_name(str(names_path)) == \
        jax_corpus.read_sid_to_course_name(str(names_path))
    vid_to_sid = port_corpus.read_vid_to_sid(str(csv_path))
    res = {}
    for tag, mod in (("port", port_corpus), ("jax", jax_corpus)):
        src, out = tmp_path / tag / "raw", tmp_path / tag / "bucketed"
        os.makedirs(src)
        for i, (name, secs) in enumerate([("lec1", 2.0), ("lec2", 1.0), ("lec4", 0.5)]):
            write_flac(str(src / f"{name}.flac"), _audio(secs, i))
        r = mod.categorize_corpus(sorted(str(p) for p in src.glob("*.flac")), str(out),
                                  vid_to_sid, move=move)
        tsv = tmp_path / tag / "categories.tsv"
        dist = mod.category_time_distribution(str(out), tsv_path=str(tsv))
        base = str(tmp_path / tag)
        res[tag] = json.loads(json.dumps([
            dataclasses.asdict(r), dist, tsv.read_text(),
            sorted(os.path.relpath(os.path.join(d, f), base)
                   for d, _, fs in os.walk(base) for f in fs)]).replace(base, "BASE"))
    assert res["port"] == res["jax"]
    layout, dist = res["port"][0], res["port"][1]
    assert layout["categories"] == {"900": 1, "100": 1, "unknown": 1}
    assert layout["unknown_vids"] == ["lec4"]
    # layout only: the buckets exist and hold nothing yet
    moved = {"900": 2.0, "100": 1.0, "unknown": 0.5} if move else {}
    assert dist == pytest.approx({c: moved.get(c, 0.0) for c in port_corpus.category_names()})


@pytest.mark.parametrize("out", ["tensor", "tuple", "dict", "dataclass", "none"])
def test_device_time_on_cpu(out):
    """Seconds per call; the output's first tensor is found through tuples,
    dicts and dataclasses (a CPU tensor needs no synchronisation)."""

    @dataclasses.dataclass
    class Res:
        n: int
        x: torch.Tensor

    calls = []

    def fn(x):
        calls.append(1)
        y = x * 2
        return {"tensor": y, "tuple": (1, [y]), "dict": {"a": None, "b": y},
                "dataclass": Res(1, y), "none": None}[out]

    dt = profiling.device_time(fn, torch.ones(8, 8), iters=3, warmup=2)
    assert dt >= 0 and len(calls) == 5
    assert (profiling._first_tensor(fn(torch.ones(2))) is None) == (out == "none")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


PANELS = {
    "params_vs_mer_scatter": lambda out: figures.params_vs_mer_scatter(
        [{"name": "teacher", "params_m": 1550, "mer": 13.96, "group": "baseline"},
         {"name": "student-32-2", "params_m": 756, "mer": 11.44, "group": "K2D"}], out),
    "filter_threshold_curves": lambda out: figures.filter_threshold_curves(
        {"MER": [{"threshold": t, "remaining_pct": 100 * t} for t in (1.0, 0.6, 0.2)],
         "PER": [{"threshold": t, "remaining_pct": 90 * t} for t in (1.0, 0.6, 0.2)]}, out),
    "params_vs_mer_panels": lambda out: figures.params_vs_mer_panels(
        [{"title": t, "points": [{"name": "Ours 32-2", "params_m": 756, "mer": m},
                                 {"name": "large-v2", "params_m": 1550, "mer": m + 2}]}
         for t, m in (("in-domain", 11.4), ("out-of-domain", 15.0))], out),
}


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_figures_write_files(tmp_path, panel):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / f"{panel}.png")
    assert PANELS[panel](out) == out
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_figures_raise_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="figures require matplotlib"):
        PANELS["params_vs_mer_scatter"](str(tmp_path / "a.png"))


def test_push_to_hub_through_a_stub(tmp_path, monkeypatch):
    calls = []

    class HfApi:
        def create_repo(self, **kw):
            calls.append(("create_repo", kw))

        def upload_folder(self, **kw):
            calls.append(("upload_folder", kw))

    stub = types.ModuleType("huggingface_hub")
    stub.HfApi = HfApi
    monkeypatch.setitem(sys.modules, "huggingface_hub", stub)
    url = hub.push_to_hub(str(tmp_path), "org/student-32-2", private=False)
    assert url == "https://huggingface.co/org/student-32-2"
    assert calls == [
        ("create_repo", dict(repo_id="org/student-32-2", private=False, exist_ok=True)),
        ("upload_folder", dict(folder_path=str(tmp_path), repo_id="org/student-32-2",
                               commit_message="upload model"))]


def test_push_to_hub_without_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="requires the huggingface_hub package"):
        hub.push_to_hub(str(tmp_path), "org/x")
