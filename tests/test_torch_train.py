"""The port's training step against the JAX package's on the same weights
(``from_jax_params``) and the same numpy batches, fp32 policy: the losses,
three steps of ``make_train_step`` with the encoder frozen and trainable
(JAX differentiates its XLA attention there, the port its plain attention
under per-layer checkpointing), gradient accumulation, and the masked
optimizer's state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.models.params import init_student_from_teacher as jax_student
from taiwan_whisper_tpu.train import distill as JD
from taiwan_whisper_tpu.train import state as JS
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, named_leaves
from taiwan_whisper_tpu_torch.train import distill as TD
from taiwan_whisper_tpu_torch.train import state as TS

CFG = dict(vocab_size=256, num_mel_bins=80, d_model=64, ffn_dim=128, encoder_layers=2,
           decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
           max_source_positions=60, max_target_positions=32)
FP32 = DtypePolicy.fp32()
JFP32 = JaxPolicy.fp32()


def _batch(b=4, u=8, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 256, (b, u)).astype(np.int32)
    labels[:, :2] = -100  # prompt positions masked
    labels[-1, -3:] = -100  # padding
    return {"mel": rng.randn(b, 120, 80).astype(np.float32),
            "decoder_input_ids": rng.randint(0, 256, (b, u)).astype(np.int32),
            "labels": labels}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """Teacher (2 decoder layers) and its 1-layer student, in both packages."""
    tcfg = JaxConfig(**CFG)
    teacher = jax_init_params(tcfg, seed=0)
    student = jax_student(teacher, tcfg, 1)
    pcfg = WhisperConfig(**CFG)
    return dict(jt=teacher, js=student, jtcfg=tcfg, jscfg=tcfg.with_decoder_layers(1),
                pt=from_jax_params(teacher, pcfg),
                ps=from_jax_params(student, pcfg.with_decoder_layers(1)),
                ptcfg=pcfg, pscfg=pcfg.with_decoder_layers(1))


def _assert_params_close(port, jax_params, cfg, atol):
    ref = dict(named_leaves(from_jax_params(jax_params, cfg)))
    for path, t in named_leaves(port):
        np.testing.assert_allclose(t.detach().numpy(), ref[path].numpy(), atol=atol,
                                   rtol=0, err_msg=path)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    t_logits = rng.randn(3, 5, 40).astype(np.float32) * 3
    s_logits = rng.randn(3, 5, 40).astype(np.float32) * 3
    labels = rng.randint(0, 40, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    labels[2, -1] = -100
    ce_j, n_j = JD.masked_cross_entropy(jnp.asarray(s_logits), jnp.asarray(labels))
    ce_t, n_t = TD.masked_cross_entropy(torch.from_numpy(s_logits), torch.from_numpy(labels))
    assert int(n_t) == int(n_j) == 12
    np.testing.assert_allclose(float(ce_t), float(ce_j), rtol=1e-6)
    kl_j, _ = JD.kl_divergence(jnp.asarray(t_logits), jnp.asarray(s_logits),
                               jnp.asarray(labels), 2.0)
    kl_t, _ = TD.kl_divergence(torch.from_numpy(t_logits), torch.from_numpy(s_logits),
                               torch.from_numpy(labels), 2.0)
    np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-6)


def test_distill_loss_with_mse_matches_jax(models):
    m = models
    batch = _batch(seed=1)
    dcfg_j = JD.DistillConfig(mse_weight=0.5)
    dcfg_t = TD.DistillConfig(mse_weight=0.5)
    loss_j, met_j = JD.distill_loss(m["js"], m["jt"], _jax(batch), m["jscfg"], m["jtcfg"],
                                    dcfg_j, JFP32)
    loss_t, met_t = TD.distill_loss(m["ps"], m["pt"], _torch(batch), m["pscfg"], m["ptcfg"],
                                    dcfg_t, FP32)
    assert set(met_t) == set(met_j) == {"ce", "kl", "mse", "loss"}
    # kl is a small difference of O(1) terms: an absolute floor of 1e-6
    # (fp32 rounding of the logits) beside the relative 1e-6
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)


def _run_steps(m, freeze, ocfg, batches):
    """The same steps in both packages -> (jax params, port params, metrics)."""
    dj = JD.DistillConfig(freeze_encoder=freeze)
    dt = TD.DistillConfig(freeze_encoder=freeze)
    opt_j = JS.make_optimizer(ocfg[0], mask=JS.trainable_mask(m["js"], freeze))
    step_j = jax.jit(JD.make_train_step(m["jscfg"], m["jtcfg"], dj, opt_j, JFP32))
    pj, sj = m["js"], opt_j.init(m["js"])
    pt = {k: v for k, v in from_jax_params(m["js"], m["pscfg"]).items()}
    opt_t = TS.make_optimizer(ocfg[1], mask=TS.trainable_mask(pt, freeze))
    step_t = TD.make_train_step(m["pscfg"], m["ptcfg"], dt, opt_t, FP32)
    st = opt_t.init(pt)
    metrics = []
    for b in batches:
        pj, sj, mj = step_j(pj, sj, m["jt"], _jax(b))
        pt, st, mt = step_t(pt, st, m["pt"], _torch(b))
        metrics.append((jax.device_get(mj), mt))
    return pj, pt, st, metrics


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen_encoder", "trainable_encoder"])
def test_three_train_steps_match_jax(models, freeze):
    """Warmup gives lr 0 at step 0, so three steps: 0, 5e-4 and 1e-3."""
    ocfg = (JS.OptimConfig(learning_rate=1e-3, warmup_steps=2),
            TS.OptimConfig(learning_rate=1e-3, warmup_steps=2))
    batches = [_batch(seed=s) for s in range(3)]
    pj, pt, st, metrics = _run_steps(models, freeze, ocfg, batches)
    for mj, mt in metrics:
        assert set(mt) == set(mj) == {"ce", "kl", "loss", "grad_norm"}
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    _assert_params_close(pt, pj, models["pscfg"], atol=1e-5)
    # frozen leaves kept their values and got no optimizer state
    start = dict(named_leaves(models["ps"]))
    leaves = dict(named_leaves(pt))
    assert torch.equal(leaves["decoder.embed_positions"], start["decoder.embed_positions"])
    assert "decoder.embed_positions" not in st["mu"]
    enc_moments = [p for p in st["mu"] if p.startswith("encoder.")]
    if freeze:
        assert not enc_moments
        assert all(torch.equal(leaves[p], start[p]) for p in leaves if p.startswith("encoder."))
    else:
        assert len(enc_moments) == sum(1 for p in leaves if p.startswith("encoder."))
        assert not torch.equal(leaves["encoder.layers.0.fc1.weight"],
                               start["encoder.layers.0.fc1.weight"])
    assert set(st["mu"]) == set(TD.trainable_paths(pt, freeze)) | (
        set() if freeze else {"encoder.embed_positions"})


def test_grad_accumulation_matches_jax(models):
    """Two updates of two accumulated micro-batches each (warmup 1: the
    first update has lr 0, the second 1e-3)."""
    ocfg = (JS.OptimConfig(learning_rate=1e-3, warmup_steps=1, grad_accum_steps=2),
            TS.OptimConfig(learning_rate=1e-3, warmup_steps=1, grad_accum_steps=2))
    batches = [_batch(b=2, seed=10 + s) for s in range(4)]
    pj, pt, st, metrics = _run_steps(models, True, ocfg, batches)
    for mj, mt in metrics:
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
    _assert_params_close(pt, pj, models["pscfg"], atol=1e-5)
    assert st["gradient_step"] == 2 and st["mini_step"] == 0 and st["inner"]["count"] == 2
    start = dict(named_leaves(models["ps"]))
    moved = dict(named_leaves(pt))["decoder.layers.0.fc1.weight"]
    assert not torch.equal(moved, start["decoder.layers.0.fc1.weight"])


def test_schedules_match_optax():
    for kw in (dict(warmup_steps=3), dict(warmup_steps=0),
               dict(warmup_steps=2, schedule="linear", total_steps=7)):
        j = JS.make_schedule(JS.OptimConfig(learning_rate=3e-4, **kw))
        t = TS.make_schedule(TS.OptimConfig(learning_rate=3e-4, **kw))
        for count in range(10):
            np.testing.assert_allclose(float(t(count)), float(j(count)), rtol=1e-7,
                                       err_msg=f"{kw} count {count}")


def test_checkpoint_manager_rotation_keep_and_resume(tmp_path):
    cm = TS.CheckpointManager(str(tmp_path), save_total_limit=2)
    state = {"params": {"w": torch.ones(3, requires_grad=True)}, "opt_state": {"count": 1}}
    cm.save(10, state)
    cm.save(20, {"params": {"w": torch.full((3,), 2.0)}, "opt_state": {"count": 2}}, keep=True)
    cm.save(30, {"params": {"w": torch.full((3,), 3.0)}, "opt_state": {"count": 3}})
    cm.save(40, {"params": {"w": torch.full((3,), 4.0)}, "opt_state": {"count": 4}})
    cm.save(20, {"params": {"w": torch.full((3,), 2.5)}, "opt_state": {"count": 2}})
    assert cm.all_steps() == [20, 30, 40]  # 10 rotated out, 20 kept (re-save too)
    restored, step = cm.restore()
    assert step == 40 and restored["opt_state"]["count"] == 4
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), 4.0)
    assert TS.CheckpointManager(str(tmp_path / "empty")).restore() == (None, None)
