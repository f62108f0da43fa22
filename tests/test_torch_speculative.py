"""The port's multi-token ``extend`` and speculative decoding against the
JAX package at the fp32 policy on the CPU: extend's logits and cache
writes at every offset, and ``speculative_decode``'s tokens, length,
rounds and draft accept rate against JAX's and against the port's own
teacher greedy decode (greedy-exact), parametrised as
tests/test_speculative.py is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.decode.rules import DecodeRules as JaxRules
from taiwan_whisper_tpu.decode.speculative import speculative_decode as jax_speculative_decode
from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.models.params import init_student_from_teacher as jax_student
from taiwan_whisper_tpu_torch.decode.greedy import cross_kv_mode, greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules
from taiwan_whisper_tpu_torch.decode.speculative import speculative_decode
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params
from taiwan_whisper_tpu_torch.ops.decode_attention import time_minor_copy
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer
from torch_threads import one_torch_thread  # noqa: F401

FP32 = DtypePolicy.fp32()
JFP32 = JaxPolicy.fp32()


def _cfg(dec_layers, **kw):
    return dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
                encoder_layers=1, decoder_layers=dec_layers, encoder_attention_heads=4,
                decoder_attention_heads=4, max_source_positions=60,
                max_target_positions=96, **kw)


def _port(jparams, dec_layers):
    cfg = WhisperConfig(**_cfg(dec_layers))
    return prepare_params(from_jax_params(jparams, cfg), FP32, "cpu"), cfg


@pytest.fixture(scope="module")
def teacher():
    jcfg = JaxConfig(**_cfg(2))
    jp = jax_init_params(jcfg, seed=0)
    return jp, jcfg, *_port(jp, 2)


@pytest.fixture(scope="module")
def extend_jit():
    return jax.jit(JM.extend, static_argnames=("config", "policy", "beams", "int8_dots"))


@pytest.mark.parametrize("plen", [1, 2, 3, 4, 5, 6])
def test_extend_matches_jax(teacher, extend_jit, plen):
    """P tokens at every offset 0 .. S - P of a 16-position cache holding
    random K/V: logits to 1e-5; the P written positions to 1e-6 of JAX's
    (fp32 products summed in another order) and every other position
    bitwise as it was."""
    jp, jcfg, params, cfg = teacher
    s = 16
    rng = np.random.RandomState(plen)
    enc = rng.randn(2, 60, 64).astype(np.float32)
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(enc), jcfg, JFP32)
    kv = M.precompute_cross_kv(params, torch.from_numpy(enc), cfg, FP32)
    ck, cv = (rng.randn(2, 2, 4, 16, s).astype(np.float32) for _ in range(2))
    for offset in range(s - plen + 1):
        tokens = rng.randint(0, MULTILINGUAL.vocab_size, (2, plen)).astype(np.int32)
        jlogits, jcache = extend_jit(jp, jkv, JM.KVCache(k=jnp.asarray(ck), v=jnp.asarray(cv)),
                                     jnp.asarray(tokens), jnp.int32(offset), config=jcfg,
                                     policy=JFP32)
        cache = M.KVCache(k=time_minor_copy(torch.from_numpy(ck)),
                          v=time_minor_copy(torch.from_numpy(cv)))
        with torch.inference_mode():
            logits = M.extend(params, kv, cache, torch.from_numpy(tokens), offset, cfg, FP32)
        assert logits.dtype == torch.float32 and logits.shape == (2, plen, MULTILINGUAL.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
        written = slice(offset, offset + plen)
        for got, want, before in ((cache.k, jcache.k, ck), (cache.v, jcache.v, cv)):
            got, want = got.numpy(), np.asarray(want)
            np.testing.assert_allclose(got[..., written], want[..., written], atol=1e-6)
            keep = np.ones(s, bool)
            keep[written] = False
            np.testing.assert_array_equal(got[..., keep], before[..., keep])


@pytest.mark.parametrize("beams,quantize", [(2, 0), (1, "8x8"), (2, "8x8")])
def test_extend_beams_and_int8_dots_match_jax(teacher, extend_jit, beams, quantize):
    """``extend`` with beams (2 rows per cross-K/V item) and on "8x8"
    storage (int8 cross K/V, int8 x int8 dots), 3 tokens at offsets 0, 5
    and 13 of a 16-position cache: logits to 1e-5 (plain storage) or to
    1e-4 of the largest logit with equal argmax ("8x8", as
    tests/test_torch_quant.py holds its steps), written cache positions to
    1e-6."""
    jp, jcfg, params, cfg = teacher
    s, plen, items = 16, 3, 2
    rng = np.random.RandomState(7)
    enc = rng.randn(items, 60, 64).astype(np.float32)
    bits, int8_dots = cross_kv_mode(quantize)
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(enc), jcfg, JFP32, quantize=bits)
    kv = M.precompute_cross_kv(params, torch.from_numpy(enc), cfg, FP32, quantize=bits)
    ck, cv = (rng.randn(2, items * beams, 4, 16, s).astype(np.float32) for _ in range(2))
    for offset in (0, 5, s - plen):
        tokens = rng.randint(0, MULTILINGUAL.vocab_size, (items * beams, plen)).astype(np.int32)
        jlogits, jcache = extend_jit(jp, jkv, JM.KVCache(k=jnp.asarray(ck), v=jnp.asarray(cv)),
                                     jnp.asarray(tokens), jnp.int32(offset), config=jcfg,
                                     policy=JFP32, beams=beams, int8_dots=int8_dots)
        cache = M.KVCache(k=time_minor_copy(torch.from_numpy(ck)),
                          v=time_minor_copy(torch.from_numpy(cv)))
        with torch.inference_mode():
            logits = M.extend(params, kv, cache, torch.from_numpy(tokens), offset, cfg, FP32,
                              beams=beams, int8_dots=int8_dots).numpy()
        want = np.asarray(jlogits)
        tol = 1e-4 * np.abs(want).max() if int8_dots else 1e-5
        np.testing.assert_allclose(logits, want, atol=tol)
        np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))
        written = slice(offset, offset + plen)
        np.testing.assert_allclose(cache.k.numpy()[..., written],
                                   np.asarray(jcache.k)[..., written], atol=1e-6)
        np.testing.assert_allclose(cache.v.numpy()[..., written],
                                   np.asarray(jcache.v)[..., written], atol=1e-6)


def test_extend_refuses_positions_past_the_cache(teacher):
    _, _, params, cfg = teacher
    cache = M.init_cache(params, cfg, 1, 8, torch.float32)
    kv = M.precompute_cross_kv(params, torch.zeros(1, 60, 64), cfg, FP32)
    with pytest.raises(ValueError, match="positions 5..8"):
        M.extend(params, kv, cache, torch.zeros(1, 4, dtype=torch.int32), 5, cfg, FP32)


def _run_both(teacher, student_jp, student_layers, timestamps, k=4):
    """JAX speculative_decode and the port's on the same encodings, with
    the port's teacher greedy_decode beside them."""
    jp, jcfg, params, cfg = teacher
    scfg = jcfg.with_decoder_layers(student_layers)
    sparams, pcfg = _port(student_jp, student_layers)
    tok = WhisperTokenizer()
    prefix = np.asarray([tok.sot_sequence("zh", timestamps=timestamps)], np.int32)
    mel = jnp.asarray(np.random.RandomState(3).randn(1, 120, 80).astype(np.float32) * 0.5)
    t_enc = JM.encode(jp, mel, jcfg, JFP32)
    s_enc = JM.encode(student_jp, mel, scfg, JFP32)
    max_len = prefix.shape[1] + 48
    want = jax_speculative_decode(jp, jcfg, student_jp, scfg, t_enc, s_enc, jnp.asarray(prefix),
                                  JaxRules.from_special(MULTILINGUAL, timestamps=timestamps),
                                  JFP32, num_draft_tokens=k, max_len=max_len)
    rules = DecodeRules.from_special(MULTILINGUAL, timestamps=timestamps)
    te, se = (torch.from_numpy(np.array(x)) for x in (t_enc, s_enc))
    got = speculative_decode(params, cfg, sparams, pcfg, te, se, torch.from_numpy(prefix), rules,
                             FP32, num_draft_tokens=k, max_len=max_len, device="cpu")
    greedy = greedy_decode(params, te, torch.from_numpy(prefix), cfg, rules, FP32,
                           max_len=max_len, device="cpu")
    return want, got, greedy


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("student_kind", ["distilled", "random"])
def test_speculative_matches_jax_and_greedy(teacher, timestamps, student_kind):
    """k = 4 drafts a round: the tokens equal JAX speculative_decode's and
    the port's teacher-only greedy decode; length, rounds and the accept
    rate (fp32 division) equal JAX's."""
    jp, jcfg = teacher[:2]
    student = (jax_student(jp, jcfg, 1) if student_kind == "distilled"
               else jax_init_params(jcfg.with_decoder_layers(1), seed=7))
    want, got, greedy = _run_both(teacher, student, 1, timestamps)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), greedy.tokens.numpy())
    assert got.length == int(want.length) == int(greedy.lengths[0])
    assert got.rounds == int(want.rounds) >= 1
    assert got.draft_accept_rate == float(want.draft_accept_rate)
    assert isinstance(got.length, int) and isinstance(got.draft_accept_rate, float)


def test_speculative_teacher_as_its_own_assistant(teacher):
    """The teacher drafting for itself with k = 5: most drafts agree. Not
    all: after a round that accepts all k, the last draft's position was
    never fed to the drafting model, so its cache holds a stale entry there
    for the next round, as in the JAX function; the rounds and the rate
    equal JAX's, and the tokens greedy's."""
    jp = teacher[0]
    want, got, greedy = _run_both(teacher, jp, 2, True, k=5)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens.numpy(), greedy.tokens.numpy())
    assert got.rounds == int(want.rounds) and got.length == int(want.length)
    assert got.draft_accept_rate == float(want.draft_accept_rate) > 0.5


def test_speculative_takes_one_utterance(teacher):
    _, _, params, cfg = teacher
    with pytest.raises(ValueError, match="one utterance"):
        speculative_decode(params, cfg, params, cfg, torch.zeros(2, 60, 64),
                           torch.zeros(2, 60, 64), torch.zeros(2, 3, dtype=torch.int32),
                           DecodeRules.from_special(MULTILINGUAL), FP32, device="cpu")
