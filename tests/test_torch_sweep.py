"""The port's sweep module against the JAX package's: ``load_sweep`` and
``expand_configs`` on the YAMLs of tests/test_sweep.py for several seeds
and caps, ``run_sweep``'s ``sweep_results.jsonl`` and ``best.json`` with
one fake runner (a failing run recorded), both stubbed-wandb agent cases
with the payloads they log, the default runner (the port's ``cli.main``),
and one real ``cli sweep --target distill`` of two runs on the CPU."""

import dataclasses
import json
import math
import os
import sys
import types

import numpy as np
import pytest

from taiwan_whisper_tpu.audio.io import write_wav
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.pipeline import sweep as jax_sweep
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL, bytes_to_unicode
from taiwan_whisper_tpu_torch import cli as port_cli
from taiwan_whisper_tpu_torch.pipeline import sweep as port_sweep

GRID_YAML = """
method: grid
metric:
  goal: minimize
  name: train/loss
parameters:
  learning_rate:
    values: [0.001, 0.0001]
  batch_size:
    values: [2, 4]
  max_steps:
    value: 3
"""

RANDOM_YAML = """
method: random
metric:
  goal: maximize
  name: mer
parameters:
  learning_rate:
    min: 0.00001
    max: 0.001
    distribution: log_uniform_values
  temperature:
    values: [1.0, 2.0]
"""

# a random sweep over every kind of range, a fixed scalar and a bool flag
MIXED_YAML = """
method: random
parameters:
  warmup_steps:
    min: 1
    max: 40
    distribution: int_uniform
  kl_weight:
    min: 0.5
    max: 2.0
  mse_weight: 0.0
  freeze_encoder:
    values: [true, false]
  batch_size:
    values: [8, 16, 32]
"""

YAMLS = {"grid": GRID_YAML, "random": RANDOM_YAML, "mixed": MIXED_YAML}


def _write(tmp_path, text):
    p = tmp_path / "sweep.yaml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name", sorted(YAMLS))
@pytest.mark.parametrize("seed,max_runs", [(0, 0), (1, 16), (7, 3), (123, 5)])
def test_expand_configs_matches_jax(tmp_path, name, seed, max_runs):
    path = _write(tmp_path, YAMLS[name])
    spec, ref_spec = port_sweep.load_sweep(path), jax_sweep.load_sweep(path)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    got = port_sweep.expand_configs(spec, max_runs=max_runs, seed=seed)
    assert got == jax_sweep.expand_configs(ref_spec, max_runs=max_runs, seed=seed)
    assert got and [port_sweep._to_argv("distill", c, ["--x"]) for c in got] == \
        [jax_sweep._to_argv("distill", c, ["--x"]) for c in got]


@pytest.mark.parametrize("text,err", [
    ("method: grid\nparameters:\n  lr: {min: 1, max: 2}\n", "require method: random"),
    ("method: grid\nparameters:\n  lr: {bogus: 1}\n", "unsupported parameter spec"),
    ("method: bayes\nparameters:\n  lr: {values: [1]}\n", "unsupported sweep method"),
], ids=["grid_with_range", "bad_spec", "bad_method"])
def test_sweep_errors_match_jax(tmp_path, text, err):
    path = _write(tmp_path, text)
    for mod in (port_sweep, jax_sweep):
        with pytest.raises(ValueError, match=err):
            mod.expand_configs(mod.load_sweep(path))


@pytest.mark.parametrize("result,name", [
    ({"loss": 1.5, "train/loss": 2.5}, "train/loss"), ({"loss": 1.5}, "train/loss"),
    ({"mer": 0.3, "wer": 0.4}, None), ({"wer": 0.4}, "eval/cer"), ({}, "loss"),
    (None, "loss"), ({"steps_per_s": 3.0}, None),
])
def test_lookup_metric_matches_jax(result, name):
    assert port_sweep._lookup_metric(result, name) == jax_sweep._lookup_metric(result, name)


def _fake_runner(calls):
    def run(argv):
        calls.append(argv)
        assert argv[0] == "distill"
        lr = float(argv[argv.index("--learning_rate") + 1])
        bs = float(argv[argv.index("--batch_size") + 1])
        if math.isclose(lr, 1e-4) and bs == 4:
            raise RuntimeError("boom")  # failures are recorded, not fatal
        return {"loss": lr * bs, "note": "x"}

    return run


@pytest.mark.parametrize("name,max_runs", [("grid", 0), ("grid", 3), ("random", 6)])
def test_run_sweep_matches_jax(tmp_path, name, max_runs):
    """The same fake runner under both packages: argv, records and summary
    equal once each output directory is swapped for the other."""
    path = _write(tmp_path, YAMLS[name])
    runs = {}
    for tag, mod in (("port", port_sweep), ("jax", jax_sweep)):
        calls = []
        runner = _fake_runner(calls) if name == "grid" else (
            lambda argv, calls=calls: calls.append(argv) or {
                "mer": float(argv[argv.index("--learning_rate") + 1]) * 1e3})
        out = str(tmp_path / tag)
        summary = mod.run_sweep(path, "distill", out, extra_argv=["--manifest", "m.tsv"],
                                max_runs=max_runs, seed=5, runner=runner)
        with open(os.path.join(out, "sweep_results.jsonl")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(out, "best.json")) as f:
            best = json.load(f)
        runs[tag] = json.loads(json.dumps([calls, records, best, summary]).replace(out, "OUT"))
    assert runs["port"] == runs["jax"]
    records = runs["port"][1]
    assert len(records) == (max_runs or 4) and len({r["params"]["output_dir"] for r in records}) \
        == len(records)
    if name == "grid":
        assert sum("error" in r for r in records) == (1 if max_runs == 0 else 0)


def _stub_wandb(monkeypatch, served, logged, finished, state, expect_id="sw-123"):
    class _Run:
        def __init__(self, cfg, rid):
            self.config = dict(cfg)
            self.id = rid

        def log(self, d):
            logged.append(d)

        def finish(self):
            finished.append(self.id)

    wandb = types.ModuleType("wandb")

    def _sweep(doc, project=None, entity=None):
        state["doc"], state["project"] = doc, project
        return "sw-123"

    def _agent(sweep_id, function=None, count=None, project=None, entity=None):
        assert sweep_id == expect_id
        for i in range(count or 1):
            state["next"] = _Run(served[i], f"r{i}")
            function()

    wandb.sweep, wandb.agent = _sweep, _agent
    wandb.init = lambda *a, **k: state["next"]
    monkeypatch.setitem(sys.modules, "wandb", wandb)


@pytest.mark.parametrize("join", [False, True], ids=["new_sweep", "join_existing"])
def test_run_sweep_agent_matches_jax(tmp_path, monkeypatch, join):
    """tests/test_sweep.py's agent cases on both packages: the registered
    sweep, the runs' argv, the payloads logged back and the finished runs.
    Joined by id without a YAML, no metric name is known and the metric is
    logged under the result's own keys only (both packages)."""
    served = [{"learning_rate": 1e-3, "batch_size": 2, "max_steps": 3, "freeze_encoder": True},
              {"learning_rate": 1e-4, "batch_size": 4, "max_steps": 3}]
    seen = {}
    for tag, mod in (("port", port_sweep), ("jax", jax_sweep)):
        logged, finished, state, calls = [], [], {}, []
        _stub_wandb(monkeypatch, served, logged, finished, state,
                    expect_id="existing-id" if join else "sw-123")

        def runner(argv, calls=calls):
            calls.append(argv)
            return {"loss": float(argv[argv.index("--learning_rate") + 1]) * 10, "tag": "t"}

        out = str(tmp_path / tag)
        res = mod.run_sweep_agent(None if join else _write(tmp_path, GRID_YAML), "distill", out,
                                  ["--device", "cpu"], sweep_id="existing-id" if join else None,
                                  project="k2d", count=None if join else 2, runner=runner)
        seen[tag] = (res, json.loads(json.dumps(calls).replace(out, "OUT")), logged, finished,
                     state.get("doc"), state.get("project"))
    assert seen["port"] == seen["jax"]
    res, calls, logged = seen["port"][:3]
    if join:
        assert res == {"sweep_id": "existing-id", "runs": 1} and logged == [{"loss": 0.01}]
    else:
        assert res == {"sweep_id": "sw-123", "runs": 2}
        assert [d["train/loss"] for d in logged] == [1e-3 * 10, 1e-4 * 10]
        assert all(a[-2:] == ["--device", "cpu"] for a in calls)


def test_run_sweep_agent_needs_wandb_and_a_sweep(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="requires the wandb package"):
        port_sweep.run_sweep_agent(None, "distill", str(tmp_path), sweep_id="x")
    monkeypatch.setitem(sys.modules, "wandb", types.ModuleType("wandb"))
    with pytest.raises(ValueError, match="need --config or --sweep_id"):
        port_sweep.run_sweep_agent(None, "distill", str(tmp_path), runner=lambda a: {})


def test_default_runner_is_the_port_cli(tmp_path, monkeypatch):
    """``run_sweep`` without a runner, and ``cli sweep``, call the port's
    ``cli.main`` with each run's argv; the parser refuses a sweep without
    ``--config`` outside agent mode, as the JAX CLI does."""
    calls = []
    monkeypatch.setattr(port_cli, "main", lambda argv: calls.append(argv) or {"loss": len(calls)})
    path = _write(tmp_path, GRID_YAML)
    summary = port_sweep.run_sweep(path, "finetune", str(tmp_path / "a"), ["--device", "cpu"])
    assert len(calls) == 4 and summary["best"]["metric"] == 1.0
    args = port_cli.build_parser().parse_args([
        "sweep", "--config", path, "--target", "evaluate", "--output_dir", str(tmp_path / "b"),
        "--max_runs", "2", "--extra", "--manifest", "m.tsv", "--device", "cpu"])
    assert args.fn(args)["n_runs"] == 2
    assert [a[0] for a in calls[4:]] == ["evaluate"] * 2
    assert all(a[-4:] == ["--manifest", "m.tsv", "--device", "cpu"] for a in calls[4:])
    args = port_cli.build_parser().parse_args(
        ["sweep", "--target", "distill", "--output_dir", str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="--config is required"):
        args.fn(args)


TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128, encoder_layers=1,
            decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
            max_source_positions=60, max_target_positions=64)


def test_cli_sweep_distill_on_cpu(tmp_path):
    """A real grid of two learning rates, one step each, through ``cli
    sweep --target distill`` on a tiny teacher: two run directories with
    their exports, and ``best.json`` naming the lower of the losses the
    runs returned."""
    cfg = JaxConfig(**TINY)
    jax_save(str(tmp_path / "teacher"), jax_init_params(cfg, seed=0), cfg)
    tok = tmp_path / "tok"
    tok.mkdir()
    (tok / "vocab.json").write_text(
        json.dumps({ch: i for i, ch in enumerate(bytes_to_unicode().values())}),
        encoding="utf-8")
    (tok / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    seg = tmp_path / "segments"
    seg.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        write_wav(str(seg / f"s{i}.wav"), (rng.randn(12000) * 0.1).astype(np.float32))
        (seg / f"s{i}.txt").write_text(f"<|0.00|>你好 hello {i}<|0.40|><|endoftext|>\n\n",
                                       encoding="utf-8")
    (tmp_path / "train.tsv").write_text(
        str(seg) + "\n" + "\n".join(f"s{i}.wav" for i in range(8)) + "\n", encoding="utf-8")
    path = _write(tmp_path, "method: grid\nmetric: {name: train/loss, goal: minimize}\n"
                            "parameters:\n  learning_rate: {values: [0.01, 0.001]}\n"
                            "  max_steps: {value: 1}\n  batch_size: {value: 8}\n")
    out = tmp_path / "sweep"
    summary = port_cli.main([
        "sweep", "--config", path, "--target", "distill", "--output_dir", str(out), "--extra",
        "--manifest", str(tmp_path / "train.tsv"), "--teacher", str(tmp_path / "teacher"),
        "--student_decoder_layers", "1", "--warmup_steps", "0", "--tokenizer_dir", str(tok),
        "--logging_steps", "1", "--device", "cpu", "--compute_dtype", "fp32"])
    with open(out / "sweep_results.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["params"]["output_dir"] for r in records] == [str(out / "run_0"),
                                                            str(out / "run_1")]
    assert all("error" not in r and np.isfinite(r["metric"]) for r in records)
    for r in records:
        assert r["metric"] == r["result"]["loss"]
        assert os.path.isfile(os.path.join(r["params"]["output_dir"], "hf_export",
                                           "model.safetensors"))
    best = json.loads((out / "best.json").read_text())
    assert best == json.loads(json.dumps(summary))
    assert best["n_runs"] == 2 and best["best"]["metric"] == min(r["metric"] for r in records)
