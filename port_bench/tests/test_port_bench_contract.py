"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import os
import re

import pytest

from port_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert all(not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert bench["command"][:3] == ["python3", "-m", "port_bench.run"]


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_names_and_units(bench):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_moves_are_reported_where_listed(bench):
    """Every cell that reports a per-layer metric reports what it moves, and
    every cell reports setup_s, another end-to-end metric and a per-layer
    metric."""
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(harness.cells_reporting(bench, m)) <= set(
            harness.cells_reporting(bench, moved)), m["name"]
    for w in bench["workloads"]:
        e2e = [e["name"] for e in bench["end_to_end"]
               if w["name"] in harness.cells_reporting(bench, e)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in harness.cells_reporting(bench, m) for m in bench["per_layer"])


def test_layers_are_named_as_perf_md_lists_them(bench):
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as f:
        rows = {line.split("|")[1].strip() for line in f if line.startswith("| ")}
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["layer"] in rows, m["layer"]


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_cell_files_found_by_name(bench, cell):
    p = harness.plan(ROOT, cell, bench)
    assert os.path.exists(p.driver_path)
    assert p.config["name"] == p.cell["config"]
    mods = harness.load_metrics(p)
    assert set(mods) == {m["name"] for m in p.per_layer}
    assert all(hasattr(m, "read") for m in mods.values())
    assert {m["name"] for m in p.end_to_end} >= {"setup_s"}


def test_every_metric_has_its_file(bench):
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, harness.metric_file(bench, m["name"])))


def test_configs_keep_published_widths(bench):
    """No width differs from the published config.json: only keys listed
    in ``reduced`` may."""
    published = {"d_model": 1280, "encoder_attention_heads": 20, "decoder_attention_heads": 20,
                 "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120, "vocab_size": 51865,
                 "num_mel_bins": 80, "max_source_positions": 1500,
                 "max_target_positions": 448, "encoder_layers": 32}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        for k, v in published.items():
            assert cfg[k] == v or k in c["reduced"], (c["name"], k)
