"""The port's tensor parallel on the CPU (gloo ranks, each a process of its
own: tests/torch_spawn.py) against the JAX package on one device, at the
fp32 policy, tiny models (d 64, 4 heads, ffn 128) and seeded numpy inputs:

* one distill step (encoder trainable, every layer of the encoder and of
  the student decoder checkpointed) on a model-2 grid (2 ranks) and a
  data-2 x model-2 grid (4 ranks) equals the JAX single-device
  ``make_train_step``: loss rtol 2e-5 and the gathered parameters atol
  1e-4, as tests/test_train.py::test_sharded_train_step_matches_single_device
  holds the JAX package's own mesh;
* greedy and beam-3 decoding with the weights split over 2 and 4 ranks
  give the JAX single-device tokens exactly, on every rank, as
  tests/test_tp_decode.py holds JAX's mesh;
* ``cli distill`` and ``cli finetune --distributed --model_parallel 2`` in
  the ``tp`` (2 ranks) and ``dptp`` (4 ranks, data 2 x model 2)
  topologies of tests/test_multiprocess.py::test_two_process_full_pipeline
  end within 5e-3 of the JAX package's one-process ``run_distillation``
  and ``run_finetuning`` losses and export full shapes; a checkpoint the
  ``tp`` run saved resumes in one process, and it and a one-process
  checkpoint resume under ``--model_parallel 2``, to the one-process
  run's next loss; ``--model_parallel 3`` on 2 ranks raises before
  training.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.decode.beam import beam_decode as jax_beam_decode
from taiwan_whisper_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from taiwan_whisper_tpu.decode.rules import DecodeRules as JaxRules
from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.models.params import init_student_from_teacher as jax_student
from taiwan_whisper_tpu.text.tokenizer import MULTILINGUAL, WhisperTokenizer
from taiwan_whisper_tpu.train import distill as JD
from taiwan_whisper_tpu.train import state as JS
from taiwan_whisper_tpu_torch.models.config import WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, named_leaves
from torch_spawn import finish, start

JFP32 = JaxPolicy.fp32()
TRAIN_CFG = dict(vocab_size=256, num_mel_bins=80, d_model=64, ffn_dim=128, encoder_layers=2,
                 decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
                 max_source_positions=60, max_target_positions=32)
DECODE_CFG = dict(TRAIN_CFG, vocab_size=MULTILINGUAL.vocab_size, max_target_positions=48)
GREEDY_LEN, BEAM_LEN, BEAMS = 32, 24, 3
LR = 1e-3

# the ranks of each set run their jobs in turn, each job on its own grid:
# set -> (world, ((job, model size), ...))
GRIDS = {"pair": (2, (("train", 2), ("decode", 2))),
         "quad": (4, (("train", 2), ("decode", 4)))}
# a test's grid -> (rank set, job)
TRAIN_GRIDS = {"model2": "pair", "data2xmodel2": "quad"}
DECODE_GRIDS = {"model2": "pair", "model4": "quad"}

CLI_CFG = dict(DECODE_CFG, encoder_layers=1, max_target_positions=64)
CLI_STEPS, CLI_BATCH = 2, 8
TEXTS = ["<|0.00|>你好 hello<|0.40|><|0.50|>world 世界<|1.00|><|endoftext|>",
         "<|0.00|>第二段 second<|0.60|><|0.70|>跨越邊界<|1.10|><|continued|><|endoftext|>",
         "plain text without any marker 中文"]
# (topology, world) of tests/test_multiprocess.py's runs at --model_parallel 2
TOPOLOGIES = (("tp", 2), ("dptp", 4))
CLI_WORKER = "import sys\nfrom taiwan_whisper_tpu_torch import cli\ncli.main(sys.argv[1:])\n"
# every rank joins the run once (a process cannot join a second run), then
# calls the CLI with each JSON argv in turn, printing each ValueError
REFUSE_WORKER = r"""
import json, sys
from taiwan_whisper_tpu_torch import cli
from taiwan_whisper_tpu_torch.parallel import mesh
mesh.init_distributed("cpu")
for argv in json.loads(sys.argv[1]):
    try:
        cli.main(argv)
    except ValueError as e:
        print("refused:", argv[0], e, flush=True)
mesh.shutdown()
"""

# one rank of a set: per job, a grid of the job's model size, the rank's
# shards of the inputs' full weights, the train step (the full parameters
# gathered back) or the decodes on its data rank's rows
WORKER = r"""
import sys
import torch
from taiwan_whisper_tpu_torch.decode.beam import beam_decode
from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import named_leaves, prepare_params
from taiwan_whisper_tpu_torch.parallel import mesh, specs
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL
from taiwan_whisper_tpu_torch.train.distill import DistillConfig, make_train_step
from taiwan_whisper_tpu_torch.train.state import OptimConfig, make_optimizer, trainable_mask

inputs, out, jobs = sys.argv[1], sys.argv[2], sys.argv[3:]
mesh.init_distributed("cpu")
d = torch.load(inputs, weights_only=True)
fp32 = DtypePolicy.fp32()

def shard(tree, cfg):
    return specs.shard_params(tree, mesh.model_rank(), mesh.model_size(), cfg)

def train(rows):
    tcfg = WhisperConfig(**d["train_cfg"])
    scfg = tcfg.with_decoder_layers(1)
    student, teacher = shard(d["student"], scfg), shard(d["teacher"], tcfg)
    opt = make_optimizer(OptimConfig(learning_rate=d["lr"], warmup_steps=0),
                         mask=trainable_mask(student, False))
    step = make_train_step(scfg, tcfg, DistillConfig(freeze_encoder=False, remat_student=True),
                           opt, fp32)
    batch = {k: v[rows] for k, v in d["batch"].items()}
    student, _, metrics = step(student, opt.init(student), teacher, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {p: specs.gather_leaf(p, t).detach() for p, t in named_leaves(student)}}

def decode(rows):
    cfg = WhisperConfig(**d["decode_cfg"])
    params = prepare_params(shard(d["decode_params"], cfg), fp32, "cpu")
    rules = DecodeRules.from_special(MULTILINGUAL)
    with torch.inference_mode():
        enc = M.encode(params, d["mel"][rows], cfg, fp32)
    prefix = d["prefix"][rows]
    return {"greedy": greedy_decode(params, enc, prefix, cfg, rules, fp32,
                                    max_len=d["greedy_len"], device="cpu").tokens,
            "beam": beam_decode(params, enc, prefix, cfg, rules, fp32, num_beams=d["beams"],
                                max_len=d["beam_len"], device="cpu").tokens}

got = {}
for job in jobs:
    name, model = job.split(":")
    mesh.make_mesh(int(model))
    rows = slice(mesh.data_rank() * d["rows"] // mesh.data_size(),
                 (mesh.data_rank() + 1) * d["rows"] // mesh.data_size())
    got[name] = globals()[name](rows)
torch.save(got, "%s/rank%d.pt" % (out, mesh.rank()))
mesh.shutdown()
"""


def _train_batch(b=4, u=8, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 256, (b, u)).astype(np.int32)
    labels[:, :2] = -100  # prompt positions masked
    labels[-1, -3:] = -100  # padding
    return {"mel": rng.randn(b, 120, 80).astype(np.float32),
            "decoder_input_ids": rng.randint(0, 256, (b, u)).astype(np.int32),
            "labels": labels}


def _grid_inputs(d):
    """The grids' inputs, written for the ranks; the JAX package's weights
    and arrays for the references."""
    tcfg = JaxConfig(**TRAIN_CFG)
    teacher = jax_init_params(tcfg, seed=0)
    student = jax_student(teacher, tcfg, 1)
    dec_params = jax_init_params(JaxConfig(**DECODE_CFG), seed=0)
    batch = _train_batch()
    mel = np.random.RandomState(5).randn(4, 120, 80).astype(np.float32) * 0.5
    prefix = np.asarray([WhisperTokenizer(MULTILINGUAL).sot_sequence("zh")] * 4, np.int32)
    port_cfg = WhisperConfig(**TRAIN_CFG)
    torch.save({"train_cfg": TRAIN_CFG, "decode_cfg": DECODE_CFG, "lr": LR, "rows": 4,
                "teacher": from_jax_params(teacher, port_cfg),
                "student": from_jax_params(student, port_cfg.with_decoder_layers(1)),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "decode_params": from_jax_params(dec_params, WhisperConfig(**DECODE_CFG)),
                "mel": torch.from_numpy(mel), "prefix": torch.from_numpy(prefix),
                "greedy_len": GREEDY_LEN, "beam_len": BEAM_LEN, "beams": BEAMS},
               d / "inputs.pt")
    return dict(teacher=teacher, student=student, dec_params=dec_params, batch=batch,
                mel=mel, prefix=prefix)


def _grid_references(x):
    """JAX on one device: the train step's metrics and parameters (in the
    port's layout), greedy and beam-3 tokens."""
    tcfg, dcfg = JaxConfig(**TRAIN_CFG), JaxConfig(**DECODE_CFG)
    student, teacher = x["student"], x["teacher"]
    opt = JS.make_optimizer(JS.OptimConfig(learning_rate=LR, warmup_steps=0),
                            mask=JS.trainable_mask(student, False))
    step = jax.jit(JD.make_train_step(
        tcfg.with_decoder_layers(1), tcfg,
        JD.DistillConfig(freeze_encoder=False, remat_student=True), opt, JFP32))
    p1, _, m1 = step(student, opt.init(student), teacher,
                     {k: jnp.asarray(v) for k, v in x["batch"].items()})
    rules = JaxRules.from_special(MULTILINGUAL)
    mel, prefix = jnp.asarray(x["mel"]), jnp.asarray(x["prefix"])

    def enc(params):
        return JM.encode(params, mel, dcfg, JFP32)

    greedy = jax.jit(lambda p: jax_greedy_decode(p, enc(p), prefix, dcfg, rules, JFP32,
                                                 max_len=GREEDY_LEN).tokens)
    beam = jax.jit(lambda p: jax_beam_decode(p, enc(p), prefix, dcfg, rules, JFP32,
                                             num_beams=BEAMS, max_len=BEAM_LEN).tokens)
    port_cfg = WhisperConfig(**TRAIN_CFG).with_decoder_layers(1)
    return {"metrics": {k: float(v) for k, v in m1.items()},
            "params": dict(named_leaves(from_jax_params(jax.device_get(p1), port_cfg))),
            "greedy": np.asarray(greedy(x["dec_params"])),
            "beam": np.asarray(beam(x["dec_params"]))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank of every run below started at once: the grid sets, the
    CLI topologies, the one-process port distill (3 steps) and the refused
    runs; the JAX references computed meanwhile in this process. Returns (grid references, each set's per-rank results, the CLI
    runs' directory, each run's per-rank outputs)."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    x = _grid_inputs(d)
    _cli_corpus(d)
    procs = {}
    for name, (world, jobs) in GRIDS.items():
        os.makedirs(d / name)
        procs[name] = start(WORKER, world, [d / "inputs.pt", d / name,
                                            *(f"{job}:{m}" for job, m in jobs)])
    for sub in ("distill", "finetune"):
        for topo, world in TOPOLOGIES:
            procs[topo, sub] = start(CLI_WORKER, world,
                                     _cli_args(d, sub, d / f"{topo}_{sub}", CLI_STEPS)
                                     + ["--distributed", "--model_parallel", "2"])
    procs["port_distill"] = start(CLI_WORKER, 1,
                                  _cli_args(d, "distill", d / "port_distill", CLI_STEPS + 1))
    refused = [_cli_args(d, sub, d / f"refused_{sub}", CLI_STEPS) + ["--model_parallel", "3"]
               for sub in ("distill", "finetune")]
    procs["refused"] = start(REFUSE_WORKER, 2, [json.dumps(refused)])
    try:
        ref = _grid_references(x)
        _cli_references(d)
    finally:
        outs = {k: finish(p, timeout=300) for k, p in procs.items()}
    ranks = {name: [torch.load(d / name / f"rank{r}.pt", weights_only=True)
                    for r in range(world)] for name, (world, _) in GRIDS.items()}
    return ref, ranks, d, outs


@pytest.mark.parametrize("grid", ["model2", "data2xmodel2"])
def test_train_step_matches_jax_single_device(runs, grid):
    """Every rank logs the global batch's metrics and, gathered over its
    model group, the single-device parameters."""
    ref, ranks = runs[:2]
    ranks = [rank["train"] for rank in ranks[TRAIN_GRIDS[grid]]]
    assert set(ranks[0]["metrics"]) == set(ref["metrics"]) == {"ce", "kl", "loss", "grad_norm"}
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=2e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                                   rtol=2e-5, err_msg=f"rank {r}")
        assert set(got["params"]) == set(ref["params"])
        for path, want in ref["params"].items():
            assert got["params"][path].shape == want.shape, path
            np.testing.assert_allclose(got["params"][path].numpy(), want.numpy(), atol=1e-4,
                                       rtol=0, err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("grid", ["model2", "model4"])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_matches_jax_single_device(runs, grid, mode):
    """Greedy (32 positions) and beam-3 (24) with every layer split over
    the grid's model group: each rank's tokens equal JAX's exactly."""
    ref, ranks = runs[:2]
    for r, rank in enumerate(ranks[DECODE_GRIDS[grid]]):
        np.testing.assert_array_equal(rank["decode"][mode].numpy(), ref[mode],
                                      err_msg=f"rank {r}")


def _cli_args(corpus, sub, out, steps):
    model = (["--teacher", str(corpus / "teacher"), "--student_decoder_layers", "1",
              "--eval_manifest", str(corpus / "train.tsv"), "--eval_steps", str(CLI_STEPS),
              "--gen_eval_batches", "1"] if sub == "distill"
             else ["--model", str(corpus / "teacher")])
    return [sub, "--manifest", str(corpus / "train.tsv"), "--output_dir", str(out),
            "--max_steps", str(steps), "--batch_size", str(CLI_BATCH), "--learning_rate",
            str(LR), "--warmup_steps", "1", "--tokenizer_dir", str(corpus / "tok"),
            "--logging_steps", "1", "--device", "cpu", "--compute_dtype", "fp32", *model]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _losses(run_dir):
    return {r["step"]: r["train/loss"] for r in _records(run_dir) if "train/loss" in r}


def _cli_corpus(d):
    """A tiny teacher (MULTILINGUAL vocab, 1 encoder and 2 decoder
    layers), a byte-level vocab and 8 WAV segments with 2-line
    transcripts."""
    from taiwan_whisper_tpu.audio.io import write_wav
    from taiwan_whisper_tpu.models.io import save_hf_checkpoint as jax_save
    from taiwan_whisper_tpu.text.tokenizer import bytes_to_unicode

    jax_save(str(d / "teacher"), jax_init_params(JaxConfig(**CLI_CFG), seed=0),
             JaxConfig(**CLI_CFG))
    (d / "tok").mkdir()
    (d / "tok" / "vocab.json").write_text(
        json.dumps({ch: i for i, ch in enumerate(bytes_to_unicode().values())}),
        encoding="utf-8")
    (d / "tok" / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    (d / "seg").mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        write_wav(str(d / "seg" / f"s{i}.wav"),
                  (rng.randn(int((0.8 + 0.1 * i) * 16000)) * 0.1).astype(np.float32))
        prev = TEXTS[(i + 1) % len(TEXTS)] if i % 3 else ""
        (d / "seg" / f"s{i}.txt").write_text(f"{TEXTS[i % len(TEXTS)]}\n{prev}\n",
                                             encoding="utf-8")
    (d / "train.tsv").write_text(
        str(d / "seg") + "\n" + "".join(f"s{i}.wav\n" for i in range(8)), encoding="utf-8")


def _cli_references(d):
    """The JAX package's run_distillation and run_finetuning (encoder
    trainable, no language-embedding mix, as ``cli finetune`` runs it) for
    the CLI runs' 2 steps at batch 8, one process."""
    from taiwan_whisper_tpu.pipeline.dataset import TrainPrepConfig
    from taiwan_whisper_tpu.pipeline.distill_driver import (DistillRunConfig,
                                                            run_distillation, run_finetuning)

    common = dict(opt_cfg=JS.OptimConfig(learning_rate=LR, warmup_steps=1,
                                         total_steps=CLI_STEPS),
                  tokenizer_dir=str(d / "tok"), policy=JFP32)
    run_distillation(str(d / "train.tsv"), str(d / "teacher"), str(d / "jax_distill"),
                     student_decoder_layers=1,
                     run_cfg=DistillRunConfig(max_steps=CLI_STEPS, batch_size=CLI_BATCH,
                                              logging_steps=1), **common)
    run_finetuning(str(d / "train.tsv"), str(d / "teacher"), str(d / "jax_finetune"),
                   freeze_encoder=False,
                   run_cfg=DistillRunConfig(max_steps=CLI_STEPS, batch_size=CLI_BATCH,
                                            logging_steps=1, mix_lang_embeddings=False),
                   prep_cfg=TrainPrepConfig(language="zh"), **common)


def _assert_exports_close(a, b, atol):
    from taiwan_whisper_tpu_torch.models.io import read_safetensors

    ta = read_safetensors(str(a / "hf_export" / "model.safetensors"))
    tb = read_safetensors(str(b / "hf_export" / "model.safetensors"))
    assert set(ta) == set(tb)
    for k, t in ta.items():
        assert t.shape == tb[k].shape, k
        np.testing.assert_allclose(t.numpy(), tb[k].numpy(), atol=atol, rtol=0, err_msg=k)


def _gen_eval(run_dir):
    """The generation eval's records at the last train step: MER and the
    two prediction tables."""
    out = [r for r in _records(run_dir) if r["step"] == CLI_STEPS
           and ("eval/gen_mer" in r or "table" in r)]
    for r in out:
        r.pop("time")
    return out


@pytest.mark.parametrize("topology", [t for t, _ in TOPOLOGIES])
@pytest.mark.parametrize("sub", ["distill", "finetune"])
def test_cli_model_parallel_matches_jax(runs, sub, topology):
    """Both steps' losses within 5e-3 of the JAX package's single-process
    run's (as tests/test_multiprocess.py holds JAX's own topologies) and
    the HF export, gathered by rank 0, of full shapes and within 1e-4 of
    that run's; for distill the generation eval (decoded by model group 0)
    equals the one-process port run's: MER and both prediction tables."""
    d = runs[2]
    run = d / f"{topology}_{sub}"
    ref = d / f"jax_{sub}"
    got, want = _losses(run), _losses(ref)
    assert sorted(got) == sorted(want) == list(range(1, CLI_STEPS + 1))
    for step, loss in got.items():
        assert abs(loss - want[step]) < 5e-3 * max(abs(want[step]), 1.0), (step, loss,
                                                                             want[step])
    _assert_exports_close(run, ref, atol=1e-4)
    if sub == "distill":
        mine = _gen_eval(run)
        assert len(mine) == 3 and mine == _gen_eval(d / "port_distill")


def test_tp_checkpoint_resumes_in_one_process(runs, tmp_path):
    """The ``tp`` distill's checkpoint (full tensors gathered over the
    model group) resumed at --model_parallel 1 in one process: step 3's
    loss and the export equal the one-process 3-step run's to 1e-4."""
    import shutil

    from taiwan_whisper_tpu_torch import cli

    d = runs[2]
    shutil.copytree(d / "tp_distill" / "checkpoints", tmp_path / "checkpoints")
    cli.main(_cli_args(d, "distill", tmp_path, CLI_STEPS + 1))
    got, want = _losses(tmp_path), _losses(d / "port_distill")
    assert sorted(got) == [CLI_STEPS + 1]
    np.testing.assert_allclose(got[CLI_STEPS + 1], want[CLI_STEPS + 1], rtol=1e-4)
    _assert_exports_close(tmp_path, d / "port_distill", atol=1e-4)


@pytest.fixture(scope="module")
def resumed_at_model2(runs, tmp_path_factory):
    """Two 2-rank ``cli distill --distributed --model_parallel 2`` runs,
    started at once, each resuming step 2's checkpoint to step 3: the
    ``tp`` run's (saved at M = 2) and the one-process port run's (M = 1).
    Returns source -> run directory."""
    import shutil

    d = runs[2]
    r = tmp_path_factory.mktemp("resumed_at_model2")
    sources = {"tp": d / "tp_distill" / "checkpoints" / f"checkpoint-{CLI_STEPS}",
               "one_process": d / "port_distill" / "checkpoints" / f"checkpoint-{CLI_STEPS}"}
    procs = {}
    for name, ckpt in sources.items():
        shutil.copytree(ckpt, r / name / "checkpoints" / ckpt.name)
        procs[name] = start(CLI_WORKER, 2, _cli_args(d, "distill", r / name, CLI_STEPS + 1)
                            + ["--distributed", "--model_parallel", "2"])
    for p in procs.values():
        finish(p, timeout=300)
    return {name: r / name for name in sources}


@pytest.mark.parametrize("source", ["tp", "one_process"])
def test_checkpoint_resumes_under_model_parallel(runs, resumed_at_model2, source):
    """A step-2 checkpoint (full tensors, saved at M = 2 or in one process)
    resumed at --model_parallel 2, each rank cutting its shards of the
    params and of both AdamW moments: step 3's loss and the export,
    gathered back to full shapes, equal the one-process 3-step run's to
    1e-4."""
    run, want = resumed_at_model2[source], runs[2] / "port_distill"
    got = _losses(run)
    assert sorted(got) == [CLI_STEPS + 1]
    np.testing.assert_allclose(got[CLI_STEPS + 1], _losses(want)[CLI_STEPS + 1], rtol=1e-4)
    _assert_exports_close(run, want, atol=1e-4)


@pytest.mark.parametrize("sub", ["distill", "finetune"])
def test_model_parallel_that_does_not_divide_the_world_raises(runs, sub):
    """--model_parallel 3 on 2 ranks: every rank raises ValueError before
    any model loads, as JAX's make_mesh refuses the mesh."""
    d, outs = runs[2:]
    for out in outs["refused"]:
        assert f"refused: {sub} 2 processes do not divide by --model_parallel 3" in out, out
    assert not os.path.exists(d / f"refused_{sub}" / "metrics.jsonl")
