"""A temporary copy of the benchmark at a tiny size, for the CPU tests:
``BENCHMARK.json`` with its cells pointed at tiny configurations (every
width but the vocabulary and the 30 s context cut) and tiny traffic files
(a few lectures or segments, batches of 4, a few tokens). The cells keep
their names, drivers and metrics; the beam-search and fine-tuning mixes,
which no cell of ``BENCHMARK.json`` runs yet, are added as cells."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=128,
            decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=128)


# cell -> (config, traffic, the cell whose metrics it reports)
KEPT = {"label.large-v2.beam5": ("whisper-large-v2", "label_beam5_b8_int8",
                                 "label.large-v2.greedy"),
        "finetune.32-2.b32": ("distil-large-v2-32-2", "finetune_b32", "distill.32-2.b32")}


def _tiny_traffic(path: str):
    with open(path, encoding="utf-8") as f:
        tr = json.load(f)
    if tr["driver"] == "label_files":
        tr["label"].update(batch_size=4, max_decode_tokens=8)
        tr["lectures"].update(seconds=[60, 120], base_s=60)
        tr["check"]["sample_rows"] = 4
        tr["batches"] = 1
        tr["trace"].update(batch=0, loop_from=2, loop_steps=4)
    else:
        tr.update(batch_size=4, segments=dict(n=16, pool=8, seconds=[2, 6], noise_dbfs=-50),
                  trace=dict(main="step", **{"from": 1}, steps=2))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(tr, f)


def make_tiny_root(dst: str) -> str:
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(dst, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cfg_dir = os.path.join(dst, "port_bench", "configs")
    tr_dir = os.path.join(dst, "port_bench", "traffic")
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        cfg.update(TINY, decoder_layers=2 if cfg["decoder_layers"] > 2 else 1)
        with open(os.path.join(dst, c["file"]), "w", encoding="utf-8") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        _tiny_traffic(os.path.join(tr_dir, f"{w['traffic']}.json"))
    # the mixes kept for later cells (PERF.md, Open questions): their paths
    # stay covered here as cells of the tiny copy
    for name, (config, traffic, like) in KEPT.items():
        _tiny_traffic(os.path.join(tr_dir, f"{traffic}.json"))
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "kept for a later cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(bench, f, indent=1)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
