"""The port's greedy decoding against the JAX package: the fused rules
argmax on logits with planted ties, and greedy_decode token for token at
the fp32 policy for quantize 0 / int8 / fp8; the row-padded cross K/V and
cache against contiguous copies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from taiwan_whisper_tpu.decode.rules import DecodeRules as JaxRules
from taiwan_whisper_tpu.decode.rules import greedy_rules_argmax as jax_rules_argmax
from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules, greedy_rules_argmax
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params
from taiwan_whisper_tpu_torch.ops.decode_attention import padded_length
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer

TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
            encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, max_source_positions=60, max_target_positions=48)
TB = MULTILINGUAL.timestamp_begin
EOT = MULTILINGUAL.eot


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_rules_argmax_matches_jax_with_ties(step):
    rng = np.random.RandomState(step)
    v = MULTILINGUAL.vocab_size
    logits = rng.randn(8, v).astype(np.float32)
    logits[0, 100] = logits[0, TB + 3] = 20.0  # text/timestamp tie -> text
    logits[1, 200] = logits[1, 300] = 20.0  # tie inside the text region
    logits[2, TB + 10] = logits[2, TB + 20] = 20.0  # tie inside timestamps
    logits[3, TB:] += 4.0  # timestamp mass beats the best text token
    logits[4, EOT] = 30.0
    logits[5] = 0.0  # all equal
    last = np.array([TB + 5, TB + 5, 400, TB + 7, EOT - 1, TB, TB + 9, 1], np.int32)
    penult = np.array([TB + 2, 300, TB + 4, 50, 51, TB, 60, 2], np.int32)
    last_ts = np.array([TB + 5, TB + 5, TB + 4, TB + 7, 0, TB, TB + 9, 0], np.int32)
    jr = JaxRules.from_special(MULTILINGUAL)
    rules = DecodeRules.from_special(MULTILINGUAL)
    jn, jl = jax_rules_argmax(
        jnp.asarray(logits), step=jnp.int32(step), last_token=jnp.asarray(last),
        penult_token=jnp.asarray(penult), last_timestamp=jnp.asarray(last_ts), rules=jr,
        suppress=jnp.asarray(jr.suppress_mask()),
        begin_suppress=jnp.asarray(jr.begin_suppress_mask()))
    n, lp = greedy_rules_argmax(
        torch.from_numpy(logits), step=step, last_token=torch.from_numpy(last),
        penult_token=torch.from_numpy(penult), last_timestamp=torch.from_numpy(last_ts),
        rules=rules, suppress=torch.from_numpy(rules.suppress_mask()),
        begin_suppress=torch.from_numpy(rules.begin_suppress_mask()))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**TINY)
    jp = jax_init_params(jcfg, seed=0)
    cfg = WhisperConfig(**TINY)
    params = prepare_params(from_jax_params(jp, cfg), DtypePolicy.fp32(), "cpu")
    enc = np.random.RandomState(3).randn(4, 60, 64).astype(np.float32)
    sot = WhisperTokenizer().sot_sequence("zh", "transcribe", timestamps=True)
    return jp, jcfg, params, cfg, enc, np.array([sot] * 4, np.int32)


@pytest.mark.parametrize("quantize", [0, 8, "fp8"])
def test_greedy_decode_matches_jax(setup, quantize):
    jp, jcfg, params, cfg, enc, prefix = setup
    max_len = prefix.shape[1] + 16
    jres = jax_greedy_decode(
        jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg, JaxRules.from_special(MULTILINGUAL),
        JaxPolicy.fp32(), max_len=max_len, quantize_cross_kv=quantize)
    res = greedy_decode(params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
                        DecodeRules.from_special(MULTILINGUAL), DtypePolicy.fp32(),
                        max_len=max_len, quantize_cross_kv=quantize, device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(jres.lengths))
    np.testing.assert_allclose(res.sum_logprobs.numpy(), np.asarray(jres.sum_logprobs),
                               atol=1e-4)
    np.testing.assert_allclose(res.no_speech_probs.numpy(),
                               np.asarray(jres.no_speech_probs), atol=1e-4)
    assert (res.tokens[:, prefix.shape[1]:] >= TB).any()  # timestamps were emitted


@pytest.mark.parametrize("quantize,valid_from", [(0, None), ("fp8", None), (8, [0, 2, 1, 0])])
def test_padded_storage_matches_contiguous(setup, quantize, valid_from):
    """The cross K/V and the cache live in row-padded storage (rows on 128
    bytes); prefill and decode_step give exactly what contiguous copies
    give, and the cross K/V hold the values of the contiguous layout."""
    _, _, params, cfg, enc, prefix = setup
    pol = DtypePolicy.fp32()
    enc_t, pre = torch.from_numpy(enc), torch.from_numpy(prefix)
    vf = None if valid_from is None else torch.tensor(valid_from, dtype=torch.int32)
    kv = M.precompute_cross_kv(params, enc_t, cfg, pol, quantize=quantize)
    cache = M.init_cache(params, cfg, 4, 21, dtype=torch.float32)
    stores = (kv.k_q, kv.v_q) if quantize else kv
    for x in (*stores, cache.k, cache.v):
        assert x.stride(-2) == padded_length(x.shape[-1], x.element_size()) > x.shape[-1]
    # layer 0's K as the contiguous layout computed it
    k0 = M._split_heads(M._dense(params["decoder"]["layers"][0]["cross_attn"]["k"], enc_t),
                        cfg.head_dim).permute(0, 2, 3, 1).contiguous()
    if quantize:
        k0 = M._quantize_kv_slice(k0, quantize)[0]
    assert torch.equal(stores[0][0].float(), k0.float())

    if quantize:
        kv_c = M.QuantCrossKV(*(x.contiguous() for x in (kv.k_q, kv.k_scale, kv.v_q,
                                                         kv.v_scale)))
    else:
        kv_c = tuple(x.contiguous() for x in kv)
    cache_c = M.KVCache(k=torch.zeros(cache.k.shape), v=torch.zeros(cache.v.shape))
    got = M.prefill(params, kv, cache, pre, cfg, pol, valid_from=vf)
    want = M.prefill(params, kv_c, cache_c, pre, cfg, pol, valid_from=vf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    token = got[0].argmax(-1)
    for i in range(pre.shape[1], pre.shape[1] + 5):
        got = M.decode_step(params, kv, cache, token, i, cfg, pol, valid_from=vf)
        want = M.decode_step(params, kv_c, cache_c, token, i, cfg, pol, valid_from=vf)
        assert torch.equal(got, want)
        token = got.argmax(-1)
    assert torch.equal(cache.k, cache_c.k) and torch.equal(cache.v, cache_c.v)


def test_greedy_decode_with_valid_from_matches_jax(setup):
    """Left-padded prompts (valid_from) through the padded cache, token for
    token against the JAX package at fp32."""
    jp, jcfg, params, cfg, enc, prefix = setup
    max_len = prefix.shape[1] + 12
    vf = np.array([0, 2, 1, 0], np.int32)
    jres = jax_greedy_decode(
        jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg, JaxRules.from_special(MULTILINGUAL),
        JaxPolicy.fp32(), max_len=max_len, valid_from=jnp.asarray(vf), quantize_cross_kv="fp8")
    res = greedy_decode(params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
                        DecodeRules.from_special(MULTILINGUAL), DtypePolicy.fp32(),
                        max_len=max_len, valid_from=torch.from_numpy(vf),
                        quantize_cross_kv="fp8", device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_allclose(res.sum_logprobs.numpy(), np.asarray(jres.sum_logprobs),
                               atol=1e-4)
