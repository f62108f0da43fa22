"""Stage 2a of the port against the JAX package: ``segment_utterances`` on
seeded utterance lists, ``segment_audio_file`` in FLAC and WAV, the
train/valid split, and ``cli segment`` / ``cli make-manifest`` writing
byte-equal audio, txt and TSV files."""

import csv
import dataclasses
import os
import shutil

import numpy as np
import pytest

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu.audio import manifest as jax_manifest
from taiwan_whisper_tpu.pipeline import segment as jax_segment
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.audio import manifest as port_manifest
from taiwan_whisper_tpu_torch.audio.io import write_flac
from taiwan_whisper_tpu_torch.pipeline import segment as port_segment

SR = 16000
WORDS = ["今天", "我們", "來", "討論", "語音", "模型", "hello", "world", "Whisper", "的",
         "code-switching", "測試", "，", "。"]


def _utterances(rng, total_s):
    """(start, end, text) rows as a label CSV holds them: back to back with
    gaps, 0.3-26 s long, times on the CSV's 3 decimals."""
    rows, t = [], float(rng.uniform(0, 3))
    while t < total_s:
        d = float(rng.choice([rng.uniform(0.3, 4), rng.uniform(2, 12), rng.uniform(12, 26)]))
        text = "".join(rng.choice(WORDS, rng.randint(1, 8)))
        rows.append((round(t, 3), round(min(t + d, total_s), 3), text))
        t += d + float(rng.choice([0.0, rng.uniform(0, 1.5)]))
    return rows


# (start, end) lists that put the start of the utterance the window is cut
# at more (and less) than 1 s before the window's 30 s end
EDGE = {
    "spill_over_1s": [(0.0, 10.0), (10.0, 20.0), (20.0, 28.0), (28.0, 45.0), (45.0, 50.0),
                      (50.0, 85.0), (85.0, 90.0)],
    "spill_under_1s": [(1.0, 12.0), (12.0, 30.5), (30.5, 44.0), (44.0, 60.7), (60.7, 75.0),
                       (75.0, 80.0)],
    "exactly_1s": [(0.0, 29.0), (29.0, 31.0), (31.0, 50.0), (50.0, 61.0), (61.0, 62.0)],
}


def _utt_lists():
    out = {f"seed{s}": _utterances(np.random.RandomState(s), 200.0) for s in range(6)}
    out.update({k: [(a, b, f"u{i}") for i, (a, b) in enumerate(v)] for k, v in EDGE.items()})
    out["empty"] = []
    return out


UTTS = _utt_lists()


@pytest.mark.parametrize("name", sorted(UTTS))
def test_segment_utterances_matches_jax(name):
    rows = UTTS[name]
    got = port_segment.segment_utterances([port_segment.Utterance(*r) for r in rows])
    ref = jax_segment.segment_utterances([jax_segment.Utterance(*r) for r in rows])
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in ref]
    if name in EDGE:
        assert ("<|continued|>" in got[0].transcript) == (name == "spill_over_1s")
    if name.startswith("seed"):
        assert len(got) >= 4 and any("<|continued|>" in s.transcript for s in got)


def _write_csv(path, rows, extra=()):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["start", "end", "text"])
        for r in rows:
            w.writerow([f"{r[0]:.3f}", f"{r[1]:.3f}", r[2]])
        for r in extra:
            w.writerow(r)


def test_read_pseudo_label_csv_matches_jax(tmp_path):
    p = str(tmp_path / "x.csv")
    _write_csv(p, UTTS["seed1"] + [(1.0, 2.0, " padded, with a comma ")],
               extra=[["1.0", "2.0"], ["1", "2", "3", "4"]])
    got = port_segment.read_pseudo_label_csv(p)
    ref = jax_segment.read_pseudo_label_csv(p)
    assert [dataclasses.asdict(u) for u in got] == [dataclasses.asdict(u) for u in ref]
    assert len(got) == len(UTTS["seed1"]) + 1


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("fmt", ["flac", "wav"])
def test_segment_audio_file_matches_jax(tmp_path, fmt):
    rng = np.random.RandomState(2)
    audio = (rng.randn(120 * SR) * 0.1).astype(np.float32)
    rows = _utterances(rng, 118.0)
    out = {}
    for name, mod in (("jax", jax_segment), ("port", port_segment)):
        rels = mod.segment_audio_file(audio, [mod.Utterance(*r) for r in rows],
                                      str(tmp_path / name), "lecture", audio_format=fmt)
        out[name] = (rels, _tree(tmp_path / name))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) >= 2 and all(r.endswith("." + fmt) for r in out["port"][0])


@pytest.mark.parametrize("percent,seed", [(0.0, 42), (0.1, 42), (0.2, 1), (0.5, 7)])
def test_split_valid_matches_jax(percent, seed):
    paths = [f"seg/{i}.flac" for i in range(57)]
    frames = list(range(1000, 1057))
    for fr in (None, frames):
        got = port_manifest.split_valid(port_manifest.Manifest("r", paths, fr), percent, seed)
        ref = jax_manifest.split_valid(jax_manifest.Manifest("r", paths, fr), percent, seed)
        assert [dataclasses.asdict(m) for m in got] == [dataclasses.asdict(m) for m in ref]


@pytest.fixture(scope="module")
def lectures(tmp_path_factory):
    """Three FLAC lectures with label CSVs and one without a CSV."""
    d = tmp_path_factory.mktemp("lectures")
    audio_dir, trans_dir = d / "audio", d / "trans"
    audio_dir.mkdir()
    trans_dir.mkdir()
    rng = np.random.RandomState(5)
    for i, secs in enumerate((95.0, 70.0, 40.0, 20.0)):
        write_flac(str(audio_dir / f"lec{i}.flac"),
                   (rng.randn(int(secs * SR)) * 0.1).astype(np.float32))
        if i < 3:
            _write_csv(str(trans_dir / f"lec{i}.csv"), _utterances(rng, secs))
    return d


def _cli_trees(tmp_path, argv_of):
    """Run the JAX CLI, then the port's, with the same argv into the same
    output directory; returns each run's files."""
    out_dir = tmp_path / "out"
    trees = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        for argv in argv_of(str(out_dir)):
            cli.main(argv)
        trees[name] = _tree(out_dir)
        shutil.rmtree(out_dir)
    return trees


@pytest.mark.parametrize("valid_percent", [None, "0.3"], ids=["train_only", "valid_0.3"])
def test_cli_segment_and_make_manifest_match_jax(tmp_path, lectures, valid_percent):
    def argv_of(out):
        seg = os.path.join(out, "segments")
        mm = ["make-manifest", "--root", seg, "--out", os.path.join(out, "manifests")]
        if valid_percent:
            mm += ["--valid_percent", valid_percent, "--seed", "3"]
        return [["segment", "--trans_dir", str(lectures / "trans"),
                 "--audio_dir", str(lectures / "audio"), "--output_dir", seg], mm]

    trees = _cli_trees(tmp_path, argv_of)
    assert trees["port"] == trees["jax"]
    tree = trees["port"]
    n_audio = sum(p.endswith(".flac") for p in tree)
    assert n_audio >= 5 and sum(p.endswith(".txt") for p in tree) == n_audio
    assert not any(p.startswith(os.path.join("segments", "lec3")) for p in tree)
    lines = {k: v.decode().splitlines()[1:] for k, v in tree.items() if k.endswith(".tsv")}
    assert len(lines[os.path.join("segments", "train.tsv")]) == n_audio
    if valid_percent:
        train = lines[os.path.join("manifests", "train.tsv")]
        valid = lines[os.path.join("manifests", "valid.tsv")]
        assert valid and len(train) + len(valid) == n_audio
