"""The port's plain encoder attention (what the kernel wrapper runs on CPU
tensors) against the Pallas encoder kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.ops.attention import encoder_attention as pallas_encoder_attention
from taiwan_whisper_tpu_torch.ops.attention import attention_plain, encoder_attention


@pytest.mark.parametrize("s", [160, 300])  # 300 leaves a ragged last block
def test_encoder_attention_matches_pallas(s):
    rng = np.random.RandomState(s)
    q, k, v = (rng.randn(2, s, 4, 64).astype(np.float32) for _ in range(3))
    ref = np.asarray(pallas_encoder_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), interpret=True))
    ours = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert ours.shape == (2, s, 4, 64) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_plain_attention_mask_keeps_true():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 5, 2, 64).astype(np.float32)) for _ in range(3))
    causal = torch.tril(torch.ones(5, 5, dtype=torch.bool))[None, None]
    out = attention_plain(q, k, v, causal)
    # the first query sees only the first key: its output is v[0]
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32])
def test_plain_attention_grads_match_jax(dtype):
    """dq/dk/dv of the port's plain attention (the CPU path of the encoder
    attention's autograd function) equal jax.grad of the JAX model's
    ``_attention``."""
    import jax

    from taiwan_whisper_tpu.models.whisper import _attention
    from taiwan_whisper_tpu_torch.ops.attention import (attention_backward_plain,
                                                        encoder_attention_backward)

    rng = np.random.RandomState(3)
    q, k, v, dout = (rng.randn(2, 70, 4, 64).astype(dtype) for _ in range(4))

    def f(q, k, v):
        return jnp.sum(_attention(q, k, v, None, jnp.float32) * dout)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    got = attention_backward_plain(tq, tk, tv, tdo)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, err_msg=name)
    # the wrapper on CPU tensors is the plain version; autograd through
    # encoder_attention gives the same gradients
    wrapped = encoder_attention_backward(tq, tk, tv, None, None, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(encoder_attention(*leaves), leaves, tdo)
    for a, b, c in zip(got, wrapped, auto):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_lse_plain_is_logsumexp_of_scaled_scores():
    from taiwan_whisper_tpu_torch.ops.attention import encoder_attention_lse

    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32)) for _ in range(3))
    out, lse = encoder_attention_lse(q, k, v)
    s = np.einsum("bqhd,bkhd->bhqk", q.numpy() / 8.0, k.numpy()).astype(np.float64)
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)
    assert torch.equal(out, attention_plain(q, k, v))
