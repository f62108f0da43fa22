"""The port's hallucination audit sampler against the JAX package's: with
the same seed, ``collect_hallucinations`` and ``cli collect-hallucinations``
write byte-equal TSVs and copy the same audio files."""

import csv
import os

import pytest

from taiwan_whisper_tpu import cli as jax_cli
from taiwan_whisper_tpu.pipeline import audit as jax_audit
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.audio.manifest import Manifest, write_manifest
from taiwan_whisper_tpu_torch.pipeline import audit as port_audit

N = 24


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """N segments (2-line txts, every third one 5-line), a cleaned manifest
    that kept the even indices and index 9, two hyp shards (index 15
    missing) and a filter CSV."""
    d = tmp_path_factory.mktemp("audit")
    root = d / "root"
    (root / "lec").mkdir(parents=True)
    paths = []
    for i in range(N):
        rel = f"lec/{i}.flac"
        (root / rel).write_bytes(b"FLACDATA" + bytes([i]))
        if i % 3:
            txt = f"<|0.00|>你好 {i} world<|2.50|><|continued|><|endoftext|>\n<|0.00|>prev {i}\n"
        else:
            txt = (f"<|0.00|>第{i}段<|1.00|><|1.20|> text<|4.00|><|endoftext|>\n\n"
                   f"<|4.00|>尾巴 {i}<|5.00|>\n\nprev {i}\n")
        (root / f"lec/{i}.txt").write_text(txt, encoding="utf-8")
        paths.append(rel)
    write_manifest(str(d / "orig.tsv"), Manifest(root=str(root), paths=paths))
    kept = [p for i, p in enumerate(paths) if i % 2 == 0 or i == 9]
    write_manifest(str(d / "clean.tsv"), Manifest(root=str(root), paths=kept))
    for rank, ids in ((0, range(0, N, 2)), (1, range(1, N, 2))):
        with open(d / f"idx_hyp.{rank}.txt", "w", encoding="utf-8") as f:
            for i in ids:
                if i != 15:
                    f.write(f"{i}\tvalidator says {i}\n")
    with open(d / "hallucination_result.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["index", "path", "hallucinated", "mer", "reason"])
        for i in range(N):
            w.writerow([i, paths[i], int(i % 2), "" if i == 7 else f"{i / 10:.4f}",
                        "mer" if i % 2 else ""])
    return d


def _tree(root):
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dp, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("num_samples,seed,with_csv,copy_audio", [
    (5, 0, True, True), (5, 3, False, True), (1000, 1, True, False), (0, 0, False, False),
], ids=["5_seed0_diag", "5_seed3", "all_seed1_diag_no_audio", "none"])
def test_collect_hallucinations_matches_jax(tmp_path, corpus, num_samples, seed, with_csv,
                                            copy_audio):
    trees = {}
    for name, mod in (("jax", jax_audit), ("port", port_audit)):
        out = mod.collect_hallucinations(
            str(corpus / "orig.tsv"), str(corpus / "clean.tsv"),
            [str(corpus / "idx_hyp.0.txt"), str(corpus / "idx_hyp.1.txt")],
            str(tmp_path / name), num_samples=num_samples, seed=seed,
            filter_csv=str(corpus / "hallucination_result.csv") if with_csv else None,
            copy_audio=copy_audio)
        assert os.path.dirname(out) == str(tmp_path / name)
        trees[name] = _tree(tmp_path / name)
    assert trees["port"] == trees["jax"]
    rows = next(v for k, v in trees["port"].items() if k.endswith(".csv")).decode().splitlines()
    assert len(rows) == 1 + min(num_samples, N // 2 - 1)
    assert sum(k.startswith("audio_samples") for k in trees["port"]) == (
        len(rows) - 1 if copy_audio else 0)


def test_cli_collect_hallucinations_matches_jax_cli(tmp_path, corpus):
    trees = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        cli.main(["collect-hallucinations", "--original_tsv", str(corpus / "orig.tsv"),
                  "--cleaned_tsv", str(corpus / "clean.tsv"),
                  "--hyp_tsv", str(corpus / "idx_hyp.0.txt"), str(corpus / "idx_hyp.1.txt"),
                  "--output_dir", str(tmp_path / name), "--num_samples", "7", "--seed", "2",
                  "--filter_csv", str(corpus / "hallucination_result.csv")])
        trees[name] = _tree(tmp_path / name)
    assert trees["port"] == trees["jax"]
    assert "hallucinations_ex7_seed2.csv" in trees["port"]
