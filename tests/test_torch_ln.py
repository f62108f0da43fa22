"""The port's plain LayerNorm (what the kernel wrapper runs on CPU tensors)
against the Pallas kernel in interpret mode: fp32 exactly to rounding,
bf16 to one bf16 ulp, with rows that are not a multiple of its 256-row
block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.ops.layer_norm import layer_norm_pallas
from taiwan_whisper_tpu_torch.ops.layer_norm import (launch_plan, layer_norm, layer_norm_plain,
                                                     supported)


def _inputs(seed, shape, scale_std=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale = (rng.randn(shape[-1]) * scale_std).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(4, 37, 256), (1, 100, 128), (2, 20, 4096)],
                         ids=["fp32", "row_padding", "d4096"])
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
    assert not supported(60) and supported(4096)  # any d % 128 == 0, as layer_norm_pallas


# (route, chunks) at d, bf16 and fp32: a chunk is one 16-byte pack per
# lane (256 bf16 or 128 fp32 columns); rows above 2048 take two passes
@pytest.mark.parametrize("d,bf16,fp32", [
    (128, ("resident", 1), ("resident", 1)),
    (384, ("resident", 2), ("resident", 3)),
    (1280, ("resident", 5), ("resident", 10)),
    (2048, ("resident", 8), ("resident", 16)),
    (4096, ("streamed", 16), ("streamed", 32)),
])
def test_launch_plan(d, bf16, fp32):
    for itemsize, want in ((2, bf16), (4, fp32)):
        plan = launch_plan(48000, d, itemsize)
        assert (plan["route"], plan["chunks"]) == want
        per_chunk = 512 // itemsize
        assert (plan["chunks"] - 1) * per_chunk < d <= plan["chunks"] * per_chunk
        # a warp for every row, 8 a block
        assert plan["grid"] == 6000
        assert launch_plan(300, d, itemsize)["grid"] == 38
        assert launch_plan(3, d, itemsize)["grid"] == 1


def test_streamed_route_statistics_match_plain():
    """The streamed route's statistics (csrc/layer_norm.cu::ln_streamed) in
    fp32 numpy: each lane merges its 16-byte packs one by one, then the
    lanes merge over xor offsets 16 .. 1 (Chan's form), as lane 0 sees it.
    Mean and variance match the fp32 plain version's two-pass values."""
    def merge(a, b):
        (n, mean, m2), (nb, mb, m2b) = a, b
        nn = n + nb
        delta = mb - mean
        return nn, mean + delta * (nb / nn), m2 + m2b + delta * delta * (n * nb / nn)

    d, v = 4096 + 128, 8  # bf16 packs; a ragged last chunk (lanes 16..31 idle)
    row = (np.random.RandomState(5).randn(d) * 3 + 1).astype(np.float32)
    lanes = []
    for lane in range(32):
        acc = (np.float32(0), np.float32(0), np.float32(0))
        for c in range(-(-d // (32 * v))):
            col = c * 32 * v + lane * v
            if col < d:
                p = row[col:col + v]
                mb = np.float32(p.sum(dtype=np.float32) / np.float32(v))
                acc = merge(acc, (np.float32(v), mb, np.float32(((p - mb) ** 2).sum())))
        lanes.append(acc)
    for off in (16, 8, 4, 2, 1):
        lanes = [merge(lanes[i], lanes[i ^ off]) for i in range(32)]
    n, mean, m2 = lanes[0]
    assert n == d
    ref = torch.from_numpy(row)
    np.testing.assert_allclose(mean, float(ref.mean()), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m2 / d, float(((ref - ref.mean()) ** 2).mean()), rtol=1e-5)
