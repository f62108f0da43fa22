"""The port's model functions against the JAX model at the fp32 policy,
with the same weights bridged by from_jax_params: encode, the quantized
cross-KV precompute, prefill and incremental decode steps, and the
teacher-forcing decoder of training."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params

SMALL = dict(vocab_size=1000, d_model=64, ffn_dim=128, encoder_layers=2,
             decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
             max_source_positions=60, max_target_positions=32)
FP32, JFP32 = DtypePolicy.fp32(), JaxPolicy.fp32()


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**SMALL)
    jp = jax_init_params(jcfg, seed=0)
    cfg = WhisperConfig(**SMALL)
    return jp, jcfg, prepare_params(from_jax_params(jp, cfg), FP32, "cpu"), cfg


@pytest.fixture(scope="module")
def encoded(models):
    jp, jcfg, params, cfg = models
    mel = np.random.RandomState(0).randn(2, 120, 80).astype(np.float32)
    jenc = np.array(JM.encode(jp, jnp.asarray(mel), jcfg, JFP32))
    with torch.inference_mode():
        enc = M.encode(params, torch.from_numpy(mel), cfg, FP32)
    return jenc, enc


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "float8_e4m3fn" else x


def test_encode_matches_jax(encoded):
    jenc, enc = encoded
    assert enc.shape == (2, 60, 64) and enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), jenc, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("quantize", [0, 8, "fp8"])
def test_precompute_cross_kv_matches_jax(models, encoded, quantize):
    jp, jcfg, params, cfg = models
    jenc, _ = encoded
    enc = torch.from_numpy(jenc)  # the same encoder output into both
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(jenc), jcfg, JFP32, quantize=quantize)
    kv = M.precompute_cross_kv(params, enc, cfg, FP32, quantize=quantize)
    if not quantize:
        for ours, ref in zip(kv, jkv):
            assert ours.shape == (2, 2, 4, 16, 60)  # [L, B, H, Dh, T]
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        return
    k_plain, v_plain = M.precompute_cross_kv(params, enc, cfg, FP32)
    for plain, codes, scale, jcodes, jscale in (
            (k_plain, kv.k_q, kv.k_scale, jkv.k_q, jkv.k_scale),
            (v_plain, kv.v_q, kv.v_scale, jkv.v_q, jkv.v_scale)):
        assert codes.dtype == (torch.int8 if quantize == 8 else torch.float8_e4m3fn)
        assert scale.shape == (2, 2, 4, 16, 1)
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
        a, b = codes.float().numpy(), _np(jcodes).astype(np.float32)
        off = a != b
        # codes may differ only where the unrounded value sits within 1e-6
        # (relative) of the rounding boundary between the two codes
        pre = (plain.float() / scale).numpy()
        mid = (a + b) / 2
        assert np.all(np.abs(pre - mid)[off] <= 1e-6 * np.maximum(1.0, np.abs(pre))[off])
        assert off.mean() < 1e-3


@pytest.mark.parametrize("quantize", [0, "fp8"])
def test_prefill_and_steps_match_jax(models, encoded, quantize):
    jp, jcfg, params, cfg = models
    jenc, _ = encoded
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(jenc), jcfg, JFP32, quantize=quantize)
    kv = M.precompute_cross_kv(params, torch.from_numpy(jenc), cfg, FP32, quantize=quantize)
    prompt = np.array([[2, 17, 5], [2, 40, 5]], np.int32)
    max_len = 12
    jcache = JM.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    jlogits, jcache, jaux = JM.prefill(jp, jkv, jcache, jnp.asarray(prompt), jcfg, JFP32,
                                       aux_index=0)
    cache = M.init_cache(params, cfg, 2, max_len, dtype=torch.float32)
    with torch.inference_mode():
        logits, aux = M.prefill(params, kv, cache, torch.from_numpy(prompt), cfg, FP32,
                                aux_index=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-3)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), atol=1e-3)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-4)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=1e-4)
    token = np.array([7, 300], np.int32)
    for index in (3, 4, 5):
        jlogits, jcache = JM.decode_step(jp, jkv, jcache, jnp.asarray(token),
                                         jnp.int32(index), jcfg, JFP32)
        with torch.inference_mode():
            logits = M.decode_step(params, kv, cache, torch.from_numpy(token), index,
                                   cfg, FP32)
        assert logits.dtype == torch.float32 and logits.shape == (2, 1000)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-3)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-4)
        token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


def test_unported_paths_raise(models):
    """What the model refuses, now that every path is ported (extend and
    the int4 / "8x8" modes: tests/test_torch_{speculative,quant}.py): extend
    past the cache's positions, and "8x8" as a storage kind (the decoders
    map it to int8 storage plus int8 dots, as in JAX)."""
    _, _, params, cfg = models
    kv = M.precompute_cross_kv(params, torch.zeros(1, 60, 64), cfg, FP32)
    with pytest.raises(ValueError):
        M.extend(params, kv, M.init_cache(params, cfg, 1, 4, torch.float32),
                 torch.zeros(1, 2, dtype=torch.int32), 3, cfg, FP32)
    with pytest.raises(ValueError):
        M.precompute_cross_kv(params, torch.zeros(1, 60, 64), cfg, FP32, quantize="8x8")


def test_decode_train_and_forward_match_jax(models, encoded):
    """Teacher-forcing logits (with hidden states and a key mask) and
    encoder + decoder forward equal the JAX model's at fp32."""
    jp, jcfg, params, cfg = models
    jenc, enc = encoded
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 1000, (2, 9)).astype(np.int32)
    keep = np.ones((2, 9), bool)
    keep[1, :2] = False  # a left-padded prompt
    jl, jh = JM.decode_train(jp, jnp.asarray(jenc), jnp.asarray(tokens), jcfg, JFP32,
                             attention_mask=jnp.asarray(keep), output_hidden_states=True)
    with torch.no_grad():
        tl, th = M.decode_train(params, enc, torch.from_numpy(tokens), cfg, FP32,
                                attention_mask=torch.from_numpy(keep),
                                output_hidden_states=True)
    assert tl.shape == (2, 9, 1000) and th.shape == (2, 2, 9, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-4, rtol=1e-4)
    mel = np.random.RandomState(0).randn(2, 120, 80).astype(np.float32)
    jf = JM.forward(jp, jnp.asarray(mel), jnp.asarray(tokens), jcfg, JFP32)
    with torch.no_grad():
        tf = M.forward(params, torch.from_numpy(mel), torch.from_numpy(tokens), cfg, FP32)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-4, rtol=1e-4)
