"""The port's decode-step attention (plain versions, which the kernel
wrappers run on CPU tensors) against the Pallas decode kernels in
interpret mode and the JAX model's own cross-attention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.ops.decode_attention import (cross_decode_attention,
                                                     self_decode_attention)
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.ops.decode_attention import (ROW_ALIGN, SELF_SPAN_BYTES, SPAN_ALIGN,
                                                           _check_rows, cross_attention,
                                                           decode_split, padded_length,
                                                           self_attention, time_minor_copy,
                                                           time_minor_zeros)


def _t(x):
    """numpy (incl. ml_dtypes fp8) -> torch, exactly."""
    x = np.asarray(x)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_cross_matches_pallas(store):
    rng = np.random.RandomState(0)
    b, h, t, d = 2, 3, 256, 64
    q = rng.randn(b, h, d).astype(np.float32) * 0.05
    if store == "int8":
        k = rng.randint(-127, 128, (b, h, t, d)).astype(np.int8)
        v = rng.randint(-127, 128, (b, h, t, d)).astype(np.int8)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = _t(k), _t(v)
    else:
        kf, vf = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(2))
        jk, jv = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16)
        tk, tv = torch.from_numpy(kf).bfloat16(), torch.from_numpy(vf).bfloat16()
    ref = np.asarray(cross_decode_attention(jnp.asarray(q), jk, jv, interpret=True))
    # the port takes q [B, R, H, Dh] and time-minor K/V [B, H, Dh, T]
    ours = cross_attention(torch.from_numpy(q)[:, None], tk.transpose(-1, -2),
                           tv.transpose(-1, -2))
    assert ours.dtype == torch.float32 and ours.shape == (b, 1, h, d)
    # int8 codes are compared as the model uses them, after the V scale
    # (~1/127): raw outputs of ~100 carry fp32 rounding above 1e-5
    v_scale = 1 / 127 if store == "int8" else 1.0
    np.testing.assert_allclose(ours[:, 0].numpy() * v_scale, ref * v_scale, atol=1e-5)


@pytest.mark.parametrize("quantize,sq", [("fp8", 1), ("fp8", 3), (8, 3), (0, 3)])
def test_cross_layer_matches_jax_model(quantize, sq):
    """The model-level cross-attention (scale folding, quantized K/V, V
    scale on the fp32 output) against the JAX model's _cross_attention."""
    rng = np.random.RandomState(1)
    b, h, d, t = 2, 4, 64, 60
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k, v = (rng.randn(b, h, d, t).astype(np.float32) for _ in range(2))
    if quantize:
        kq, ks = JM._quantize_kv_slice(jnp.asarray(k), quantize)
        vq, vs = JM._quantize_kv_slice(jnp.asarray(v), quantize)
        jslice = (kq, ks, vq, vs)
    else:
        jslice = (jnp.asarray(k), jnp.asarray(v))
    ref = np.asarray(JM._cross_attention(jnp.asarray(q), jslice, jnp.float32))
    ours_slice = tuple(_t(x) for x in jslice)
    if not quantize:  # the port's layer tuple: (k, k scale, v, v scale, int4 length)
        ours_slice = (ours_slice[0], None, ours_slice[1], None)
    ours = M._cross_attention(torch.from_numpy(q), ours_slice + (None,), torch.float32)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("index,valid_from", [(0, [0, 0, 0]), (5, [0, 0, 0]),
                                              (40, [0, 3, 39]), (60, [2, 0, 59])])
def test_self_matches_pallas(index, valid_from):
    rng = np.random.RandomState(2)
    b, h, d, s = 3, 4, 64, 60
    q, k_t, v_t = (rng.randn(b, h, d).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(b, h, d, s).astype(np.float32) for _ in range(2))
    vf = np.asarray(valid_from, np.int32)
    ref = np.asarray(self_decode_attention(
        jnp.asarray(q * 0.125), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(k_t),
        jnp.asarray(v_t), jnp.int32(index), jnp.asarray(vf), interpret=True))
    ours = self_attention(*(torch.from_numpy(x) for x in (q * 0.125, ck, cv, k_t, v_t)),
                          index, torch.from_numpy(vf))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("elem", [1, 2])
@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_decode_split_at_the_encoder_length(elem, cluster):
    """The cluster split the kernels launch with at T = 1500 (fp8/int8 and
    bf16 rows): spans on 16 positions (16-byte copies for every storage
    type), every block owning positions, all of T covered."""
    c, span = decode_split(1500, elem, cluster)
    assert c == cluster and span == {2: 752, 4: 384, 8: 192}[cluster]
    assert span % SPAN_ALIGN == 0 and span * elem % 16 == 0
    assert (c - 1) * span < 1500 <= c * span


def test_decode_split_defaults():
    assert decode_split(1500, 1) == (2, 752)  # fp8 cross K/V of the label path
    assert decode_split(1500, 2) == (4, 384)
    assert decode_split(1500, 4) == (8, 192)
    assert decode_split(3000, 4) == (8, 384)  # no cluster fits 768 B: the largest
    assert decode_split(0, 2) == (1, 16)  # an empty cache: one block, current token only
    assert decode_split(3, 2, span_bytes=SELF_SPAN_BYTES) == (1, 16)
    assert decode_split(194, 2, span_bytes=SELF_SPAN_BYTES) == (1, 208)  # the label path's last
    assert decode_split(209, 2, span_bytes=SELF_SPAN_BYTES) == (2, 112)
    with pytest.raises(ValueError, match="clusters"):
        decode_split(1500, 1, 3)


@pytest.mark.parametrize("t,dtype", [(1500, torch.float8_e4m3fn), (1500, torch.int8),
                                     (1500, torch.bfloat16), (1500, torch.float32),
                                     (195, torch.bfloat16), (35, torch.float32)])
def test_time_minor_storage_rows_start_on_128_bytes(t, dtype):
    x = time_minor_zeros((2, 3, 64, t), dtype, "cpu")
    elem = x.element_size()
    assert x.shape == (2, 3, 64, t) and x.stride(-1) == 1
    assert x.stride(-2) == padded_length(t, elem) >= t
    assert x.stride(-2) * elem % ROW_ALIGN == 0 and x.stride(-2) * elem < t * elem + ROW_ALIGN
    _check_rows(x, x.stride(), "test")  # accepted
    y = time_minor_copy(torch.arange(2 * 3 * 64 * t).reshape(2, 3, 64, t).to(dtype))
    assert y.stride() == x.stride() and torch.equal(y.float(), torch.arange(
        2 * 3 * 64 * t).reshape(2, 3, 64, t).to(dtype).float())
    if t * elem % 16:  # a contiguous tensor of these rows cannot take the 16-byte copies
        with pytest.raises(ValueError, match="16 bytes"):
            bad = torch.zeros((2, 3, 64, t), dtype=dtype)
            _check_rows(bad, bad.stride(), "test")
