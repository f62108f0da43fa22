"""The port's plain LayerNorm (what the kernel wrapper runs on CPU tensors)
against the Pallas kernel in interpret mode: fp32 exactly to rounding,
bf16 to one bf16 ulp, with rows that are not a multiple of its 256-row
block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.ops.layer_norm import layer_norm_pallas
from taiwan_whisper_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain, supported


def _inputs(seed, shape, scale_std=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale = (rng.randn(shape[-1]) * scale_std).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(4, 37, 256), (1, 100, 128)], ids=["fp32", "row_padding"])
def test_ln_fp32_matches_pallas(shape):
    x, scale, bias = _inputs(0, shape)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       interpret=True))
    got = layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ln_bf16_matches_pallas_to_bf16_resolution():
    """Both round scale and bias to bf16, compute in fp32 and round the
    output once: they may differ by one bf16 ulp (2^-7 relative) where a
    value sits on a rounding boundary, and are equal elsewhere."""
    x, scale, bias = _inputs(1, (2, 300, 128))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(layer_norm_pallas(xb, jnp.asarray(scale), jnp.asarray(bias),
                                       interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = layer_norm_plain(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= np.abs(ref) * 2.0 ** -7 + 1e-30).all()
    assert (diff == 0).mean() > 0.99


def test_ln_rounds_scale_and_bias_to_x_dtype():
    x = torch.ones(1, 128, dtype=torch.bfloat16)
    x[0, 0] = 3.0
    scale = torch.full((128,), 1.0 + 2.0 ** -12)  # not a bf16 value
    bias = torch.full((128,), 2.0 ** -12)
    got = layer_norm_plain(x, scale, bias)
    want = layer_norm_plain(x, scale.to(torch.bfloat16).float(), bias.to(torch.bfloat16).float())
    assert torch.equal(got, want)


def test_supported():
    assert supported(1280) and supported(512) and supported(2048)
    assert not supported(60) and not supported(4096)
