"""The port's int4 and "8x8" cross-KV modes against the JAX package at the
fp32 policy on the CPU: int4 storage packed two positions a byte (the
JAX package keeps jnp.int4), its integers and scales, prefill / step logits
and greedy / beam tokens; the "8x8" route's int8 q and int32 scores, its
step logits and greedy tokens. The kernel wrappers run their plain versions
here (CPU tensors)."""

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
from taiwan_whisper_tpu_torch.decode.beam import beam_decode
from taiwan_whisper_tpu_torch.decode.greedy import cross_kv_mode, greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params
from taiwan_whisper_tpu_torch.ops.decode_attention import (
    cross_attention, cross_attention_int8_dots, cross_attention_plain, decode_split, pack_int4,
    padded_length, quantize_rows_int8, span_align, unpack_int4)
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
            encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, max_source_positions=60, max_target_positions=48)
FP32 = DtypePolicy.fp32()
JFP32 = JaxPolicy.fp32()


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**TINY)
    jp = jax_init_params(jcfg, seed=0)
    cfg = WhisperConfig(**TINY)
    params = prepare_params(from_jax_params(jp, cfg), FP32, "cpu")
    return jp, jcfg, params, cfg


def _enc(seed, batch=4):
    return np.random.RandomState(seed).randn(batch, 60, 64).astype(np.float32)


def _prefix(timestamps, batch=4):
    sot = WhisperTokenizer().sot_sequence("zh", "transcribe", timestamps=timestamps)
    return np.array([sot] * batch, np.int32)


@pytest.mark.parametrize("t", [1, 2, 59, 60, 1501])
def test_int4_pack_round_trips(t):
    """Every nibble value at odd and even lengths; position 2j in the low
    nibble, an odd T's last byte with a zero high nibble."""
    x = torch.from_numpy(np.random.RandomState(t).randint(-8, 8, (3, 2, t)).astype(np.int8))
    p = pack_int4(x)
    assert p.dtype == torch.uint8 and p.shape == (3, 2, (t + 1) // 2)
    assert torch.equal(unpack_int4(p, t), x)
    assert torch.equal(p[..., 0] & 0xF, (x[..., 0].to(torch.int16) & 0xF).to(torch.uint8))
    if t % 2:
        assert not (p[..., -1] >> 4).any()


def test_int4_split_and_storage():
    """int4 spans are multiples of 32 positions (16 bytes); a row of 1500
    positions is 750 bytes, stored in 768, and one block's span of 1504
    positions fits the cross kernel's 768-byte default."""
    assert span_align(0.5) == 32 and span_align(1) == 16
    assert decode_split(1500, 0.5) == (1, 1504)
    assert decode_split(1500, 0.5, 2) == (2, 768)
    assert padded_length(750, 1) == 768
    c, span = decode_split(60, 0.5)
    assert (c, span) == (1, 64) and span % 32 == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_int4_quantization_matches_jax(seed):
    """The same fp32 time-minor K through both packages' quantizer: the
    unpacked int4 integers equal JAX's jnp.int4 exactly (qmax 7, round half
    to even, clip) and the scales to 1e-7 relative."""
    x = np.random.RandomState(seed).randn(2, 4, 64, 61).astype(np.float32) * 3
    # a channel whose scale is 1.0 (max 7): its halves round to even
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :6] = [7.0, 3.5, -3.5, 0.5, 1.5, 2.5]
    jq, js = JM._quantize_kv_slice(jnp.asarray(x), 4)
    q, s = M._quantize_kv_slice(torch.from_numpy(x), 4)
    assert q.dtype == torch.uint8 and q.shape[-1] == 31
    np.testing.assert_array_equal(unpack_int4(q, 61).numpy(), np.asarray(jq.astype(jnp.int8)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(unpack_int4(q, 61)[0, 0, 0, :6].numpy(), [7, 4, -4, 0, 2, 2])


@pytest.mark.parametrize("quantize,sq", [(4, 1), (4, 3), ("8x8", 1), ("8x8", 3)])
def test_cross_layer_matches_jax_model(quantize, sq):
    """The model-level cross attention over int4 storage and through the
    "8x8" route against the JAX model's _cross_attention: int4 to 1e-5,
    "8x8" to 1e-4 of the largest output (a probability within an fp32 ulp
    of a rounding boundary of p8 may round the other way)."""
    rng = np.random.RandomState(2)
    b, h, d, t = 2, 4, 64, 60
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k, v = (rng.randn(b, h, d, t).astype(np.float32) for _ in range(2))
    bits, int8_dots = cross_kv_mode(quantize)
    jslice = tuple(x for pair in (JM._quantize_kv_slice(jnp.asarray(y), bits) for y in (k, v))
                   for x in pair)
    ref = np.asarray(JM._cross_attention(jnp.asarray(q), jslice, jnp.float32,
                                         int8_dots=int8_dots))
    kq, ks = M._quantize_kv_slice(torch.from_numpy(k), bits)
    vq, vs = M._quantize_kv_slice(torch.from_numpy(v), bits)
    ours = M._cross_attention(torch.from_numpy(q), (kq, ks, vq, vs, t if bits == 4 else None),
                              torch.float32, int8_dots=int8_dots).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5 if bits == 4 else 1e-4 * np.abs(ref).max())


def test_int4_wrapper_takes_the_logical_length():
    """The wrapper unpacks packed storage to the logical T it is given (an
    odd T ignores the last high nibble) and raises without it: the
    storage's width cannot tell an odd T from the even one above it."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 3, 4, 64).astype(np.float32) * 0.1)
    k8, v8 = (torch.from_numpy(rng.randint(-7, 8, (2, 4, 64, 59)).astype(np.int8))
              for _ in range(2))
    got = cross_attention(q, pack_int4(k8), pack_int4(v8), 59)
    assert torch.equal(got, cross_attention_plain(q, k8, v8))
    k60, v60 = (torch.nn.functional.pad(x, (0, 1)) for x in (k8, v8))
    assert torch.equal(cross_attention(q, pack_int4(k60), pack_int4(v60), 60),
                       cross_attention_plain(q, k60, v60))
    for fn in (cross_attention, cross_attention_plain):
        with pytest.raises(ValueError, match="logical length"):
            fn(q, pack_int4(k8), pack_int4(v8))


def test_int8_dots_q8_and_scores_match_jax():
    """The "8x8" route's int8 q (per (b, row, h): q / (max|q| + 1e-12) *
    127, rounded half to even, clipped) and its int32 scores equal the JAX
    formula's (taiwan_whisper_tpu/models/whisper.py:506-514) exactly; the
    whole route against JAX's to 1e-4 of the largest output."""
    rng = np.random.RandomState(5)
    b, r, h, d, t = 2, 5, 4, 64, 60
    qf = rng.randn(b, r, h, d).astype(np.float32) * 0.3
    kq = rng.randint(-127, 128, (b, h, d, t)).astype(np.int8)
    vq = rng.randint(-127, 128, (b, h, d, t)).astype(np.int8)
    jq = jnp.asarray(qf)
    jqmax = jnp.max(jnp.abs(jq), axis=-1, keepdims=True) + 1e-12
    jq8 = jnp.clip(jnp.round(jq / jqmax * 127.0), -127, 127).astype(jnp.int8)
    jscores = jnp.einsum("bqhd,bhdt->bhqt", jq8, jnp.asarray(kq),
                         preferred_element_type=jnp.int32)
    q8, qmax = quantize_rows_int8(torch.from_numpy(qf))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(qmax.numpy(), np.asarray(jqmax))
    scores = torch.einsum("bqhd,bhdt->bhqt", q8.double(), torch.from_numpy(kq).double())
    np.testing.assert_array_equal(scores.numpy().astype(np.int64), np.asarray(jscores))
    # the whole route, before the V scale: JAX's with a unit V scale
    ones = jnp.ones((b, h, d, 1), jnp.float32)
    ref = np.asarray(JM._cross_attention(jq * 8.0, (jnp.asarray(kq), ones, jnp.asarray(vq), ones),
                                         jnp.float32, int8_dots=True))
    ours = cross_attention_int8_dots(torch.from_numpy(qf), torch.from_numpy(kq),
                                     torch.from_numpy(vq)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("quantize", [4, "8x8"])
def test_prefill_and_steps_match_jax(setup, quantize):
    """Prefill of the sot sequence and 4 greedy steps with int4 or "8x8"
    cross K/V: logits to 1e-5 (int4) or to 1e-4 of the largest logit with
    equal argmax ("8x8")."""
    jp, jcfg, params, cfg = setup
    enc = _enc(3, 2)
    bits, int8_dots = cross_kv_mode(quantize)
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(enc), jcfg, JFP32, quantize=bits)
    kv = M.precompute_cross_kv(params, torch.from_numpy(enc), cfg, FP32, quantize=bits)
    prompt = _prefix(True, 2)
    jcache = JM.init_cache(jcfg, 2, 16, jnp.float32)
    cache = M.init_cache(params, cfg, 2, 16, torch.float32)

    def close(got, want):
        tol = 1e-5 if bits == 4 else 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

    jlogits, jcache, _ = JM.prefill(jp, jkv, jcache, jnp.asarray(prompt), jcfg, JFP32,
                                    int8_dots=int8_dots)
    with torch.inference_mode():
        logits, _ = M.prefill(params, kv, cache, torch.from_numpy(prompt), cfg, FP32,
                              int8_dots=int8_dots)
    close(logits.numpy(), np.asarray(jlogits))
    token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    for index in range(prompt.shape[1], prompt.shape[1] + 4):
        jlogits, jcache = JM.decode_step(jp, jkv, jcache, jnp.asarray(token), jnp.int32(index),
                                         jcfg, JFP32, int8_dots=int8_dots)
        with torch.inference_mode():
            logits = M.decode_step(params, kv, cache, torch.from_numpy(token), index, cfg,
                                   FP32, int8_dots=int8_dots)
        close(logits.numpy(), np.asarray(jlogits))
        token = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)


@pytest.mark.parametrize("timestamps", [True, False])
def test_int4_greedy_matches_jax(setup, timestamps):
    jp, jcfg, params, cfg = setup
    enc, prefix = _enc(6), _prefix(timestamps)
    max_len = prefix.shape[1] + 16
    jres = jax_greedy_decode(jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg,
                             JaxRules.from_special(MULTILINGUAL, timestamps=timestamps), JFP32,
                             max_len=max_len, quantize_cross_kv=4)
    res = greedy_decode(params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
                        DecodeRules.from_special(MULTILINGUAL, timestamps=timestamps), FP32,
                        max_len=max_len, quantize_cross_kv=4, device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))


@pytest.mark.parametrize("timestamps", [True, False])
def test_int4_beam_matches_jax(setup, timestamps):
    """Beam search with 2 beams over int4 cross K/V: equal hypotheses."""
    jp, jcfg, params, cfg = setup
    enc, prefix = _enc(7, 2), _prefix(timestamps, 2)
    max_len = prefix.shape[1] + 10
    jres = jax_beam_decode(jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg,
                           JaxRules.from_special(MULTILINGUAL, timestamps=timestamps), JFP32,
                           num_beams=2, max_len=max_len, quantize_cross_kv=4)
    res = beam_decode(params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
                      DecodeRules.from_special(MULTILINGUAL, timestamps=timestamps), FP32,
                      num_beams=2, max_len=max_len, quantize_cross_kv=4, device="cpu")
    np.testing.assert_array_equal(res.all_tokens.numpy(), np.asarray(jres.all_tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_dots_greedy_matches_jax(setup, seed):
    """greedy_decode(quantize_cross_kv="8x8"): int8 storage, int8 x int8
    cross attention in prefill and every step; equal tokens."""
    jp, jcfg, params, cfg = setup
    enc, prefix = _enc(10 + seed), _prefix(True)
    max_len = prefix.shape[1] + 16
    jres = jax_greedy_decode(jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg,
                             JaxRules.from_special(MULTILINGUAL), JFP32, max_len=max_len,
                             quantize_cross_kv="8x8")
    res = greedy_decode(params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
                        DecodeRules.from_special(MULTILINGUAL), FP32, max_len=max_len,
                        quantize_cross_kv="8x8", device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))


def test_cross_kv_modes_match_jax():
    """What each decoder's quantize_cross_kv stores and whether it takes
    int8 dots, as taiwan_whisper_tpu/decode/greedy.py:85-91 maps them; an
    unknown storage raises as in JAX."""
    assert [cross_kv_mode(m) for m in (0, False, 8, True, 4, "fp8", "8x8")] == [
        (0, False), (0, False), (8, False), (8, False), (4, False), ("fp8", False), (8, True)]
    with pytest.raises(ValueError):
        M._quantize_kv_slice(torch.zeros(1, 1, 64, 4), "8x8")
    with pytest.raises(ValueError):
        JM._quantize_kv_slice(jnp.zeros((1, 1, 64, 4)), "8x8")
