"""The port's multi-process layer (taiwan_whisper_tpu_torch/parallel) on the
CPU: ``host_local_slice`` against the JAX package's, ``init_distributed``'s
refusals and device choice (checked without a card), and a data-parallel
train step on two gloo ranks whose rows hold different label-token counts
against the one-process step on the global batch, with the named barrier
and the preemption flag's agreement."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from taiwan_whisper_tpu.parallel.mesh import host_local_slice as jax_host_local_slice
from taiwan_whisper_tpu_torch.models.config import resolve_device
from taiwan_whisper_tpu_torch.parallel import mesh
from torch_spawn import launch

LAUNCH = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost",
              MASTER_PORT="29500")


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_host_local_slice_matches_jax(world):
    for n in range(11):
        shards = [mesh.host_local_slice(n, r, world) for r in range(world)]
        assert shards == [jax_host_local_slice(n, r, world) for r in range(world)]
        assert sum((list(range(n))[s] for s in shards), []) == list(range(n))


def test_outside_a_run_every_query_answers_for_one_process():
    assert not mesh.initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    assert mesh.host_local_slice(5) == slice(0, 5)
    assert mesh.any_rank(True) and not mesh.any_rank(False)
    mesh.barrier("alone")  # no-op


@pytest.mark.parametrize("missing", mesh.LAUNCH_ENV)
def test_init_distributed_names_the_missing_variable(monkeypatch, missing):
    for k, v in LAUNCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(missing)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: pytest.fail("joined"))
    with pytest.raises(RuntimeError, match=f"{missing} is not set"):
        mesh.init_distributed("cpu")


@pytest.mark.parametrize("device,backend,want", [(None, "nccl", "cuda:1"),
                                                 ("cuda", "nccl", "cuda:1"),
                                                 ("cpu", "gloo", "cpu")])
def test_init_distributed_picks_the_local_rank_card(monkeypatch, device, backend, want):
    """LOCAL_RANK 1 of 2 visible cards: the rank's card becomes the current
    device and the device group is NCCL, initialised lazily (no
    ``device_id``); barriers go to a gloo group; in the run
    ``resolve_device(None)`` means that card. ``--device cpu`` is gloo
    throughout."""
    calls = {}
    for k, v in LAUNCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("set_device", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "new_group", lambda **kw: calls.setdefault("host", kw))
    monkeypatch.setattr(mesh, "_host_group", None)
    dev = mesh.init_distributed(device)
    assert dev == torch.device(want)
    assert calls["backend"] == backend and "device_id" not in calls
    assert (calls["rank"], calls["world_size"], calls["init_method"]) == (1, 2, "env://")
    assert calls["host"]["backend"] == "gloo"
    assert calls.get("set_device") == (dev if dev.type == "cuda" else None)
    monkeypatch.setattr(mesh, "initialized", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 1)


def test_init_distributed_refuses_a_local_rank_past_the_cards(monkeypatch):
    for k, v in LAUNCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: pytest.fail("joined"))
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 names no CUDA device"):
        mesh.init_distributed(None)


# A tiny student (1 decoder layer, encoder trainable) and its 2-layer
# teacher, and a global batch of 4 rows whose label-token counts are 3, 5,
# 14 and 16: rank 0 of 2 holds 8 tokens, rank 1 30.
SETUP = r"""
import numpy as np
import torch
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import init_params, init_student_from_teacher
from taiwan_whisper_tpu_torch.train.distill import DistillConfig, make_train_step
from taiwan_whisper_tpu_torch.train.state import OptimConfig, make_optimizer, trainable_mask

def setup():
    cfg = WhisperConfig(vocab_size=300, d_model=64, ffn_dim=128, encoder_layers=1,
                        decoder_layers=2, encoder_attention_heads=4,
                        decoder_attention_heads=4, max_source_positions=60,
                        max_target_positions=32, pad_token_id=299, bos_token_id=299,
                        eos_token_id=299, decoder_start_token_id=298)
    teacher = init_params(cfg, seed=0)
    student = init_student_from_teacher(teacher, cfg, 1)
    scfg = cfg.with_decoder_layers(1)
    dcfg = DistillConfig(mse_weight=0.5, freeze_encoder=False)
    opt = make_optimizer(OptimConfig(learning_rate=1e-4, warmup_steps=0),
                         mask=trainable_mask(student, False))
    step = make_train_step(scfg, cfg, dcfg, opt, DtypePolicy.fp32())
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 298, (4, 16))
    labels = rng.randint(0, 298, (4, 16))
    for row, n in enumerate((3, 5, 14, 16)):
        labels[row, n:] = -100
    batch = {"mel": torch.from_numpy(rng.randn(4, 120, 80).astype(np.float32)),
             "decoder_input_ids": torch.from_numpy(ids.astype(np.int32)),
             "labels": torch.from_numpy(labels.astype(np.int32))}
    return student, opt.init(student), teacher, batch, step
"""

STEP_WORKER = SETUP + r"""
import sys
from taiwan_whisper_tpu_torch.models.params import named_leaves
from taiwan_whisper_tpu_torch.parallel import mesh

mesh.init_distributed("cpu")
student, opt_state, teacher, batch, step = setup()
rows = slice(2 * mesh.rank(), 2 * mesh.rank() + 2)
mine = {k: v[rows] for k, v in batch.items()}
print("tokens", int((mine["labels"] != -100).sum()))
student, _, metrics = step(student, opt_state, teacher, mine)
if mesh.is_main():
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "params": {p: t.detach() for p, t in named_leaves(student)}}, sys.argv[1])
mesh.barrier("step_done")
print("any", mesh.any_rank(mesh.rank() == 1))
try:
    mesh.barrier("rank%d" % mesh.rank())
except RuntimeError as e:
    print("mismatch:", e)
mesh.shutdown()
"""


@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp_step") / "rank0.pt")
    outs = launch(STEP_WORKER, 2, [path], timeout=120)
    return torch.load(path, weights_only=True), outs


def test_two_rank_step_with_unequal_tokens_matches_one_rank(two_rank_step):
    """The global token count normalises both ranks' sums, so the summed
    gradients are the one-process gradient of the global batch: loss, every
    term, grad_norm and the updated parameters to 1e-6."""
    from taiwan_whisper_tpu_torch.models.params import named_leaves

    got, outs = two_rank_step
    assert ["tokens 8" in outs[0], "tokens 30" in outs[1]] == [True, True]
    ns = {}
    exec(SETUP, ns)
    student, opt_state, teacher, batch, step = ns["setup"]()
    student, _, metrics = step(student, opt_state, teacher, batch)
    assert set(got["metrics"]) == set(metrics) == {"ce", "kl", "mse", "loss", "grad_norm"}
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-6, err_msg=k)
    want = dict(named_leaves(student))
    assert set(got["params"]) == set(want)
    for p, t in want.items():
        np.testing.assert_allclose(got["params"][p].numpy(), t.detach().numpy(), atol=1e-6,
                                   rtol=0, err_msg=p)


def test_preemption_flag_and_named_barriers_agree_across_ranks(two_rank_step):
    """A flag set on rank 1 alone reads True on both ranks; ranks at
    barriers of different names both raise, naming them."""
    _, outs = two_rank_step
    for out in outs:
        assert "any True" in out
        assert "mismatch: ranks met at different barriers: ['rank0', 'rank1']" in out


def test_spawned_ranks_import_no_jax():
    """The launcher's prelude blocks jax and the JAX package in each rank."""
    out = launch("import taiwan_whisper_tpu_torch.cli\n"
                 "try:\n    import jax\nexcept ImportError:\n    print('blocked')\n", 1)
    assert out == ["blocked\n"]
