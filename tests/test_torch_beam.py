"""The port's beam search against the JAX package at the fp32 policy, tiny
preset, seeded numpy inputs: ``apply_rules`` on logits over step, last and
penult token cases; ``beam_decode`` (tokens, scores, hypotheses, lengths,
sum_logprobs, no-speech probabilities) over K, timestamps and cross-K/V
quantization; K = 1 against the port's greedy; the self-cache reorder
(padded strides kept, a NaN kept inside its beam); a planted top-k tie;
and ``prefill`` of a 227-token prompt with the beams folded into the cross
query rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.decode.beam import _gather_beams as jax_gather_beams
from taiwan_whisper_tpu.decode.beam import beam_decode as jax_beam_decode
from taiwan_whisper_tpu.decode.rules import DecodeRules as JaxRules
from taiwan_whisper_tpu.decode.rules import apply_rules as jax_apply_rules
from taiwan_whisper_tpu.models import whisper as JM
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu_torch.decode import beam as B
from taiwan_whisper_tpu_torch.decode.greedy import greedy_decode
from taiwan_whisper_tpu_torch.decode.rules import DecodeRules, apply_rules
from taiwan_whisper_tpu_torch.models import whisper as M
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params, prepare_params
from taiwan_whisper_tpu_torch.ops.decode_attention import padded_length
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer

TINY = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
            encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, max_source_positions=60, max_target_positions=240)
TB = MULTILINGUAL.timestamp_begin
EOT = MULTILINGUAL.eot
NEW_TOKENS = 14


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_apply_rules_matches_jax(step, timestamps):
    rng = np.random.RandomState(10 + step)
    v = MULTILINGUAL.vocab_size
    logits = rng.randn(8, v).astype(np.float32) * 3
    logits[3, TB:] += 4.0  # timestamp mass beats the best text token: rule 6
    logits[5] = 0.0  # all equal
    # last / penult: pair closed, pair open, text, eot-1, timestamp 0, ...
    last = np.array([TB + 5, TB + 5, 400, TB + 7, EOT - 1, TB, TB + 9, 1], np.int32)
    penult = np.array([TB + 2, 300, TB + 4, 50, 51, TB, 60, 2], np.int32)
    last_ts = np.array([TB + 5, TB + 5, TB + 4, TB + 7, 0, TB, TB + 9, 0], np.int32)
    jr = JaxRules.from_special(MULTILINGUAL, timestamps=timestamps)
    rules = DecodeRules.from_special(MULTILINGUAL, timestamps=timestamps)
    want = jax_apply_rules(
        jnp.asarray(logits), step=jnp.int32(step), last_token=jnp.asarray(last),
        penult_token=jnp.asarray(penult), last_timestamp=jnp.asarray(last_ts), rules=jr,
        suppress=jnp.asarray(jr.suppress_mask()),
        begin_suppress=jnp.asarray(jr.begin_suppress_mask()))
    got = apply_rules(
        torch.from_numpy(logits), step=step, last_token=torch.from_numpy(last),
        penult_token=torch.from_numpy(penult), last_timestamp=torch.from_numpy(last_ts),
        rules=rules, suppress=torch.from_numpy(rules.suppress_mask()),
        begin_suppress=torch.from_numpy(rules.begin_suppress_mask()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**TINY)
    jp = jax_init_params(jcfg, seed=0)
    cfg = WhisperConfig(**TINY)
    params = prepare_params(from_jax_params(jp, cfg), DtypePolicy.fp32(), "cpu")
    enc = np.random.RandomState(3).randn(2, 60, 64).astype(np.float32)
    return jp, jcfg, params, cfg, enc


def _prefix(timestamps, b=2):
    return np.array([WhisperTokenizer().sot_sequence("zh", "transcribe",
                                                     timestamps=timestamps)] * b, np.int32)


@pytest.mark.parametrize("quantize", [0, 8, "fp8"])
@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_beam_decode_matches_jax(setup, k, timestamps, quantize):
    jp, jcfg, params, cfg, enc = setup
    prefix = _prefix(timestamps)
    max_len = prefix.shape[1] + NEW_TOKENS
    want = jax_beam_decode(
        jp, jnp.asarray(enc), jnp.asarray(prefix), jcfg,
        JaxRules.from_special(MULTILINGUAL, timestamps=timestamps), JaxPolicy.fp32(),
        num_beams=k, max_len=max_len, quantize_cross_kv=quantize)
    got = B.beam_decode(
        params, torch.from_numpy(enc), torch.from_numpy(prefix), cfg,
        DecodeRules.from_special(MULTILINGUAL, timestamps=timestamps), DtypePolicy.fp32(),
        num_beams=k, max_len=max_len, quantize_cross_kv=quantize, device="cpu")
    for name in ("tokens", "all_tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("scores", "all_scores", "sum_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert (got.lengths > 0).all()


def test_beam_k1_equals_greedy(setup):
    """One beam ranks tokens as greedy argmax does, the rules being shift
    invariant: equal tokens and lengths, and the score inverts to greedy's
    sum of logprobs at the prefix plus the sampled length."""
    _, _, params, cfg, enc = setup
    prefix = torch.from_numpy(_prefix(True))
    rules = DecodeRules.from_special(MULTILINGUAL)
    max_len = prefix.shape[1] + NEW_TOKENS
    g = greedy_decode(params, torch.from_numpy(enc), prefix, cfg, rules, DtypePolicy.fp32(),
                      max_len=max_len, device="cpu")
    b = B.beam_decode(params, torch.from_numpy(enc), prefix, cfg, rules, DtypePolicy.fp32(),
                      num_beams=1, max_len=max_len, device="cpu")
    assert torch.equal(b.tokens, g.tokens) and torch.equal(b.lengths, g.lengths)
    torch.testing.assert_close(b.no_speech_probs, g.no_speech_probs)
    hyp_len = prefix.shape[1] + b.lengths.float()
    torch.testing.assert_close(b.sum_logprobs, b.scores * hyp_len)


def test_reorder_keeps_padded_strides_and_beam_of_a_nan(setup):
    """The reorder writes the surviving beams' rows of [0, i) into the spare
    cache's padded storage: its strides stay (rows on 16 bytes, as the self
    kernel needs), its values are the gathered rows, positions from i on
    are untouched, and a NaN goes only where its beam goes (the JAX
    package's one-hot product would spread it over the item's beams)."""
    _, _, params, cfg, _ = setup
    rng = np.random.RandomState(4)
    b, k, s, i = 2, 3, 21, 9
    cache = M.init_cache(params, cfg, b * k, s, dtype=torch.float32)
    spare = M.init_cache(params, cfg, b * k, s, dtype=torch.float32)
    for x in (cache.k, cache.v):
        x[..., :i] = torch.from_numpy(rng.randn(*x[..., :i].shape).astype(np.float32))
    cache.k[1, 4, 2, 7, 3] = float("nan")  # item 1, beam 1
    strides = spare.k.stride()
    new_beam = torch.tensor([[2, 0, 0], [0, 2, 1]])
    rows = (new_beam + torch.arange(b)[:, None] * k).view(-1)
    got, old = B.reorder_cache(cache, spare, rows, i)
    assert old is cache and got is spare and got.k.stride() == strides
    assert strides[-2] == padded_length(s, 4) > s
    want = jax_gather_beams(jnp.asarray(cache.k.numpy()).reshape(cfg.decoder_layers, b, k, -1)
                            .transpose(1, 2, 0, 3), jnp.asarray(new_beam.numpy()))
    want = np.asarray(want).transpose(2, 0, 1, 3).reshape(cache.k.shape)
    np.testing.assert_array_equal(got.k[..., :i].numpy(), want[..., :i])
    assert torch.equal(got.v[..., :i], cache.v[:, rows, ..., :i])
    assert not got.k[..., i:].any() and not got.v[..., i:].any()
    nan_rows = sorted({int(r) for r in torch.nonzero(got.k.isnan())[:, 1]})
    assert nan_rows == [5]  # item 1's third beam took beam 1; no other row


def test_top_k_breaks_ties_as_jax():
    """Equal values come lower index first, as jax.lax.top_k orders them;
    the planted ties include the -inf of beams past the first at step 0."""
    import jax

    x = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, 0.5, -np.inf],
                  [-np.inf] * 8,
                  [2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    x[1, 0] = B.NEG_INF  # one finite value among -infs
    for k in (2, 3, 5, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = B._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_prefill_of_a_long_prompt_with_beams_matches_jax(setup):
    """A 227-token prompt (<|startofprev|> + 223 tokens + the sot sequence)
    under 5 beams: the cross attention takes 5 x 227 query rows an item
    against K/V stored once per item."""
    jp, jcfg, params, cfg, enc = setup
    rng = np.random.RandomState(7)
    sot = WhisperTokenizer().sot_sequence("zh", "transcribe", timestamps=True)
    prompt = [MULTILINGUAL.sot_prev] + rng.randint(0, EOT, 223).tolist() + sot
    k = 5
    prefix = np.repeat(np.array([prompt] * 2, np.int32), k, axis=0)
    assert prefix.shape == (10, 227)
    sot_index = len(prompt) - len(sot)
    jkv = JM.precompute_cross_kv(jp, jnp.asarray(enc), jcfg, JaxPolicy.fp32(), quantize=8)
    jcache = JM.init_cache(jcfg, 10, 240, dtype=jnp.float32)
    want, _, want_aux = JM.prefill(jp, jkv, jcache, jnp.asarray(prefix), jcfg, JaxPolicy.fp32(),
                                   aux_index=sot_index, beams=k)
    kv = M.precompute_cross_kv(params, torch.from_numpy(enc), cfg, DtypePolicy.fp32(),
                               quantize=8)
    cache = M.init_cache(params, cfg, 10, 240, dtype=torch.float32)
    got, got_aux = M.prefill(params, kv, cache, torch.from_numpy(prefix), cfg,
                             DtypePolicy.fp32(), aux_index=sot_index, beams=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), atol=1e-4)
