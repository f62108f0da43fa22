"""Whole runs of the cells at a tiny size on the CPU (the harness's look for
a card skipped): they come out correct; a later change adds a
configuration, a mix, a driver and a metric by adding files alone; nothing
loads JAX or the JAX package; and with the timed path broken underneath,
``correct`` comes out false."""

import hashlib
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from port_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LABEL, DISTILL = "label.large-v2.greedy", "distill.32-2.b32"
BEAM, FINETUNE = "label.large-v2.beam5", "finetune.32-2.b32"


def _run(root, cell, seed=3000000019, seconds=2.0, trace=0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _cells(root):
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct(tiny_root, one_thread, trace):
    for cell in _cells(tiny_root):
        out = _run(tiny_root, cell, trace=trace)
        assert out["correct"], (cell, out["checks"])
        assert out["attempted"] > 0 and out["failed"] == 0
        assert list(out)[-1] == "checks"
        if trace == 0:
            assert "setup_s" in out["metrics"]
        else:
            assert "busy_s" in out["device"] and "breakdown" in out


def _digest(root):
    h = {}
    for base, _, files in os.walk(os.path.join(root, "port_bench")):
        for f in files:
            if f.endswith(".py") or f.endswith(".json"):
                with open(os.path.join(base, f), "rb") as fh:
                    h[os.path.relpath(os.path.join(base, f), root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return h


def test_new_config_mix_driver_and_metric_by_files_alone(tiny_root, one_thread):
    before = _digest(tiny_root)
    pb = os.path.join(tiny_root, "port_bench")
    with open(os.path.join(tiny_root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    label = next(w for w in bench["workloads"] if w["name"] == LABEL)
    with open(os.path.join(pb, "traffic", label["traffic"] + ".json"), encoding="utf-8") as f:
        mix = json.load(f)
    mix["label"]["batch_size"] = 2
    mix["driver"] = "label_files_again"
    cfg_entry = next(c for c in bench["configs"] if c["name"] == label["config"])
    with open(os.path.join(tiny_root, cfg_entry["file"]), encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-other"
    new = {
        "port_bench/configs/tiny-other.json": json.dumps(cfg),
        "port_bench/traffic/label_b2.json": json.dumps(mix),
        "port_bench/drivers/label_files_again.py":
            "from port_bench.drivers.label_files import run  # noqa: F401\n",
        "port_bench/metrics/dummy.pad_slots.py":
            "def read(rec):\n    return rec['stats']['pad_slots']\n",
    }
    for rel, text in new.items():
        with open(os.path.join(tiny_root, rel), "w", encoding="utf-8") as f:
            f.write(text)
    bench["configs"].append(dict(cfg_entry, name="tiny-other",
                                 file="port_bench/configs/tiny-other.json"))
    bench["workloads"].append(dict(label, name="label.other.b2", config="tiny-other",
                                   traffic="label_b2"))
    label_e2e = [m for m in bench["end_to_end"] if LABEL in m.get("workloads", [])]
    for m in label_e2e:
        m["workloads"].append("label.other.b2")
    bench["per_layer"].append({"name": "dummy.pad_slots", "unit": "slots", "better": "lower",
                               "source": "program_counter", "layer": "label driver",
                               "moves": label_e2e[0]["name"], "workloads": ["label.other.b2"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(bench, f)
    out = _run(tiny_root, "label.other.b2", trace=1)
    assert out["correct"]
    assert "dummy.pad_slots" in out["metrics"]
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


_PROBE = r"""
import io, json, sys
from contextlib import redirect_stdout
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def _modules(body: str, **kw) -> list:
    code = _PROBE.format(root=ROOT, body=body.format(**kw))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_command_loads_no_jax(tiny_root):
    tops = _modules(
        "from port_bench import run\n"
        "import torch; torch.set_num_threads(1)\n"
        "buf = io.StringIO()\n"
        "with redirect_stdout(buf):\n"
        "    for cell in ({label!r}, {distill!r}):\n"
        "        assert run.main(['--workload', cell, '--seed', '5', '--seconds', '1',"
        " '--trace', '1'], device='cpu', root={root!r}) == 0\n",
        label=LABEL, distill=DISTILL, root=tiny_root)
    assert "taiwan_whisper_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "taiwan_whisper_tpu"} & set(tops)


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules("import port_bench.reference.label_check, port_bench.reference.train_check")
    assert not {"jax", "jaxlib", "flax", "taiwan_whisper_tpu",
                "taiwan_whisper_tpu_torch"} & set(tops)


# --- the timed path broken underneath: correct must come out false ---------


@pytest.mark.parametrize("cell,fault", [
    (LABEL, "token_altered"), (LABEL, "half_batch_label"),
    (BEAM, "beam_token_altered"), (BEAM, "half_batch_label"),
    (DISTILL, "state_unchanged"), (DISTILL, "half_batch_train"), (DISTILL, "bias_dropped"),
    (FINETUNE, "state_unchanged"), (FINETUNE, "half_batch_train")])
def test_a_broken_timed_path_is_not_correct(tiny_root, one_thread, monkeypatch, cell, fault):
    from port_bench import faults

    faults.FAULTS[fault](monkeypatch.setattr)
    out = _run(tiny_root, cell, seed=11)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] > 0


def test_the_control_reads_worse_than_the_program(tiny_root, one_thread):
    """At the tiny size the control (the reference at fp8 in the program's
    place) reads a wider gap than the bf16 program on the same seeds; the
    limits themselves are set from the card's readings at the cells' own
    sizes (``test_port_bench_card.py``)."""
    from port_bench import readings

    for cell, key in ((LABEL, "greedy_gap_max"), (DISTILL, "loss_rel_gap")):
        rows = readings.readings(cell, [21, 22], 1.0, True, device="cpu", root=tiny_root,
                                 out=io.StringIO())
        assert max(r["control"][key] for r in rows) > max(r["program"][key] for r in rows)
