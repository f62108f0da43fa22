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


@pytest.mark.parametrize("layout", ["contiguous", "qkv_views"])
def test_tma_map_params(layout):
    """The tensor map the bf16 kernels build: dims (d, h, s, b), the byte
    strides of h, s and b read from the tensor, a box of one head's rows,
    128-byte swizzle."""
    from taiwan_whisper_tpu_torch.ops.attention import tma_map_params

    b, s, h = 2, 300, 4
    if layout == "contiguous":
        t = torch.zeros((b, s, h, 64), dtype=torch.bfloat16)
        want = (128, h * 128, s * h * 128)
    else:  # q, k or v as a view of one [B, S, 3, H, 64] buffer
        t = torch.zeros((b, s, 3, h, 64), dtype=torch.bfloat16)[:, :, 1]
        want = (128, 3 * h * 128, s * 3 * h * 128)
    got = tma_map_params(t, 64)
    assert got == {"dims": (64, h, s, b), "strides_bytes": want, "box": (64, 1, 64, 1),
                   "swizzle_bytes": 128}
    assert tma_map_params(t, 128)["box"] == (64, 1, 128, 1)


@pytest.mark.parametrize("bad", ["head_stride", "base", "fp32", "box"])
def test_tma_map_params_rejects(bad):
    """TMA needs every stride and the base on 16 bytes and a 128-byte row."""
    from taiwan_whisper_tpu_torch.ops.attention import tma_map_params

    if bad == "head_stride":  # heads 68 elements (136 bytes) apart
        t = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16)[..., :64]
    elif bad == "base":  # the whole tensor 2 bytes off
        t = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    elif bad == "fp32":
        t = torch.zeros((1, 8, 2, 64), dtype=torch.float32)
    else:
        t = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tma_map_params(t, 512 if bad == "box" else 64)


def test_tma_map_words_are_what_the_kernels_receive():
    """The bf16 C entries take twelve int64 words per tensor
    (hopper::MapParams): tma_map_params' dims, byte strides, box of
    TMA_BOX_ROWS rows and swizzle, tensor by tensor in argument order; the
    fp32 entries take none."""
    from taiwan_whisper_tpu_torch.ops.attention import TMA_BOX_ROWS, tma_map_words

    b, s, h = 2, 300, 4
    q = torch.zeros((b, s, h, 64), dtype=torch.bfloat16)
    k = torch.zeros((b, s, 3, h, 64), dtype=torch.bfloat16)[:, :, 1]
    assert list(tma_map_words(q, k)) == [
        64, h, s, b, 128, h * 128, s * h * 128, 64, 1, TMA_BOX_ROWS, 1, 128,
        64, h, s, b, 128, 3 * h * 128, s * 3 * h * 128, 64, 1, TMA_BOX_ROWS, 1, 128]
    assert tma_map_words(q.float(), k.float()) is None
