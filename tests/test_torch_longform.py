"""The port's long-form decoding against the JAX package at the fp32
policy, on a tiny preset (d 64, 30 s windows, a 64-token budget) and
about a minute of seeded noise: ``sequential_decode`` segments (raw
tokens, text tokens, start and end) greedy with the previous windows as a
prompt, without it, with beam 2 under active thresholds, and over the
sampling rungs with both packages' samplers patched to argmax (their RNG
streams differ by design); ``chunked_decode`` segments greedy and beam."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from taiwan_whisper_tpu.decode import longform as JL
from taiwan_whisper_tpu.models.config import DtypePolicy as JaxPolicy
from taiwan_whisper_tpu.models.config import WhisperConfig as JaxConfig
from taiwan_whisper_tpu.models.params import init_params as jax_init_params
from taiwan_whisper_tpu.text.tokenizer import WhisperTokenizer as JaxTokenizer
from taiwan_whisper_tpu_torch.decode import greedy as port_greedy
from taiwan_whisper_tpu_torch.decode import longform as L
from taiwan_whisper_tpu_torch.models.config import DtypePolicy, WhisperConfig
from taiwan_whisper_tpu_torch.models.params import from_jax_params
from taiwan_whisper_tpu_torch.text.tokenizer import MULTILINGUAL, WhisperTokenizer
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=MULTILINGUAL.vocab_size, d_model=64, ffn_dim=128,
             encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
             decoder_attention_heads=4, max_source_positions=1500, max_target_positions=64)
THRESHOLDS = dict(logprob_threshold=-1.0, compression_ratio_threshold=2.4,
                  no_speech_threshold=0.6)
NO_THRESHOLDS = dict(logprob_threshold=None, compression_ratio_threshold=None,
                     no_speech_threshold=None)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**SMALL)
    jp = jax_init_params(jcfg, seed=0)
    cfg = WhisperConfig(**SMALL)
    return jp, jcfg, from_jax_params(jp, cfg), cfg


def _audio(seconds, seed):
    return (np.random.RandomState(seed).randn(int(seconds * 16000)) * 0.1).astype(np.float32)


def _segments(res):
    return [(s.start, s.end, s.raw_token_ids, s.token_ids) for s in res.segments]


def _sequential_both(models, audio, **kw):
    """The JAX function takes the prompt cut-off; the port derives HF's
    from the model's positions, 64 // 2 - 1 = 31 here."""
    jp, jcfg, params, cfg = models
    want = JL.sequential_decode(jp, audio, jcfg, JaxTokenizer(), JaxPolicy.fp32(),
                                max_prompt_tokens=31, **kw)
    stats = {}
    got = L.sequential_decode(params, audio, cfg, WhisperTokenizer(), DtypePolicy.fp32(),
                              device="cpu", stats=stats, **kw)
    return _segments(want), _segments(got), stats


@pytest.mark.parametrize("case", ["greedy_conditioned", "unconditioned", "beam2_thresholds"])
def test_sequential_decode_matches_jax(models, case):
    kw = {"greedy_conditioned": dict(condition_on_prev=True, temperatures=(0.0, 0.0),
                                     **THRESHOLDS),
          "unconditioned": dict(condition_on_prev=False, temperatures=(0.0,), **NO_THRESHOLDS),
          "beam2_thresholds": dict(condition_on_prev=True, temperatures=(0.0, 0.0),
                                   num_beams=2, **THRESHOLDS)}[case]
    want, got, stats = _sequential_both(models, _audio(65, seed=11), **kw)
    assert len(want) > 1 and stats["windows"] > 1  # the window slid
    assert got == want
    if kw["condition_on_prev"]:
        assert stats["max_prefix"] > 8  # a prompt longer than the kernel's row tile ran


def test_sequential_sampling_rungs_match_jax(models, monkeypatch):
    """The t > 0 rungs with both samplers patched to argmax (a temperature
    never moves the argmax): per-rung decodes at t = 0.4 and 0.8, the last
    rung taken when every rung fails the logprob threshold, the prompt
    reset at t >= 0.5, and the sampled tokens' logprob accounting."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis)
                        .astype(jnp.int32))
    monkeypatch.setattr(port_greedy, "_sample",
                        lambda masked, temperature, generator: torch.argmax(
                            masked / temperature, dim=-1))
    want, got, stats = _sequential_both(models, _audio(65, seed=17), condition_on_prev=True,
                                        temperatures=(0.0, 0.4, 0.8), **THRESHOLDS)
    assert len(want) > 1 and stats["decodes"] > stats["windows"]  # the ladder ran
    assert got == want


@pytest.mark.parametrize("num_beams", [1, 2])
def test_chunked_decode_matches_jax(models, num_beams):
    jp, jcfg, params, cfg = models
    audio = _audio(70, seed=5)
    want = JL.chunked_decode(jp, audio, jcfg, JaxTokenizer(), JaxPolicy.fp32(), batch_size=2,
                             num_beams=num_beams, max_decode_tokens=20)
    got = L.chunked_decode(params, audio, cfg, WhisperTokenizer(), DtypePolicy.fp32(),
                           batch_size=2, num_beams=num_beams, max_decode_tokens=20,
                           device="cpu")
    assert len(want.segments) > 2
    assert _segments(got) == _segments(want)
