"""KV-cached greedy and sampled decoding (port of
taiwan_whisper_tpu/decode/greedy.py). Temperature 0 takes the fused rules
argmax; a temperature above 0 samples from the rule-masked logits over
that temperature, with a ``torch.Generator`` the caller owns (the JAX
package threads a PRNG key; the two streams differ by design, so sampled
tokens are compared only with both samplers patched to argmax).

The JAX ``lax.while_loop`` becomes a Python loop. Like the JAX loop it
runs ``decode_step`` on every iteration, including the last. Its early
exit on ``all(finished)`` costs a device-to-host sync in eager mode, so it
is polled every 8 steps: finished rows only emit eot, so the
result is the same. CUDA graphs for the step are later work.

Spans (``utils/profiling.py``): ``decode.cross_kv``, ``decode.prefill``
and ``decode.loop``; inside the loop ``decode.select`` (the rules, the
argmax or the sample, and the bookkeeping), ``decode.step`` (the
``decode_step`` call) and ``decode.poll`` (the every-8-steps sync).
Counters: ``decode.steps`` (loop iterations) and ``decode.row_steps``
(iterations times the batch's rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..utils.profiling import count, span
from .rules import DecodeRules, apply_rules, greedy_rules_argmax

_POLL_EVERY = 8  # decode steps between host checks of all(finished)


@dataclasses.dataclass
class DecodeResult:
    """tokens includes the prefix; positions past the first <|endoftext|>
    hold eot. lengths counts sampled tokens excluding eot."""

    tokens: torch.Tensor  # [B, max_len] int32
    lengths: torch.Tensor  # [B] int32
    sum_logprobs: torch.Tensor  # [B] fp32 (sampled tokens incl. eot)
    no_speech_probs: torch.Tensor  # [B] fp32
    steps: int  # decode loop iterations run (host-side)


def cross_kv_mode(quantize_cross_kv):
    """(``precompute_cross_kv``'s ``quantize``, ``int8_dots``) of a decoder's
    ``quantize_cross_kv``: 0/False off, True/8 int8, 4 int4, "fp8" e4m3,
    "8x8" int8 storage read by the int8 x int8 variant of the cross kernel."""
    if not quantize_cross_kv:
        return 0, False
    return (quantize_cross_kv if quantize_cross_kv in (4, "fp8") else 8,
            quantize_cross_kv == "8x8")


def _sample(masked: torch.Tensor, temperature: float,
            generator: torch.Generator) -> torch.Tensor:
    """One token per row drawn from softmax(masked / temperature): [B] int64."""
    probs = torch.softmax(masked / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def greedy_decode(params, enc_out: torch.Tensor, prefix: torch.Tensor,
                  config: WhisperConfig, rules: DecodeRules,
                  policy: DtypePolicy = DtypePolicy(), *,
                  max_len: Optional[int] = None, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None, sot_index: int = 0,
                  valid_from: Optional[torch.Tensor] = None,
                  quantize_cross_kv=0, device=None) -> DecodeResult:
    """Greedy (``temperature`` 0) or sampled decode of a batch: enc_out
    [B, T_enc, d], prefix [B, P] (the sot sequence, after any prompt).
    ``params`` are prepared for ``device`` (cuda unless given; raises when
    CUDA is absent). ``generator`` (on ``device``; seed 0 when not given)
    draws the samples. ``quantize_cross_kv`` as in ``cross_kv_mode``."""
    dev = resolve_device(device)
    enc_out = enc_out.to(dev)
    prefix = prefix.to(dev)
    b, p_len = prefix.shape
    max_len = max_len or config.max_target_positions
    assert p_len < max_len
    eot = rules.eot
    ts_begin = rules.timestamp_begin
    suppress = torch.from_numpy(rules.suppress_mask()).to(dev)
    begin_suppress = torch.from_numpy(rules.begin_suppress_mask()).to(dev)

    quantize, int8_dots = cross_kv_mode(quantize_cross_kv)
    with span("decode.cross_kv"):
        cross_kv = M.precompute_cross_kv(params, enc_out, config, policy, quantize=quantize)
    with span("decode.prefill"):
        cache = M.init_cache(params, config, b, max_len, dtype=policy.compute_dtype, device=dev)
        logits, sot_logits = M.prefill(params, cross_kv, cache, prefix, config, policy,
                                       valid_from=valid_from, aux_index=sot_index,
                                       int8_dots=int8_dots)
        # P(<|nospeech|>) at the <|startoftranscript|> position
        no_speech_probs = torch.softmax(sot_logits, dim=-1)[:, rules.no_speech]

    tokens = torch.full((b, max_len), eot, dtype=torch.int32, device=dev)
    tokens[:, :p_len] = prefix
    last_ts = torch.zeros(b, dtype=torch.int32, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros(b, dtype=torch.float32, device=dev)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    steps = 0
    with span("decode.loop"):
        for i in range(p_len, max_len):
            step = i - p_len
            with span("decode.select"):
                state = dict(step=step, last_token=tokens[:, i - 1],
                             penult_token=tokens[:, max(i - 2, 0)], last_timestamp=last_ts,
                             rules=rules, suppress=suppress, begin_suppress=begin_suppress)
                if temperature == 0.0:
                    nxt, logprob = greedy_rules_argmax(logits, **state)
                else:
                    masked = apply_rules(logits, **state)
                    nxt = _sample(masked, temperature, generator).to(torch.int32)
                    # the sampled token's logprob: its masked logit less the logsumexp
                    chosen = masked.gather(-1, nxt[:, None].long())[:, 0]
                    logprob = chosen - torch.logsumexp(masked, dim=-1)
                active = ~finished
                nxt = torch.where(active, nxt, eot)
                sum_logprobs += torch.where(active, logprob, 0.0)
                lengths += (active & (nxt != eot)).to(torch.int32)
                last_ts = torch.where(active & (nxt >= ts_begin), nxt, last_ts)
                tokens[:, i] = nxt
                finished |= nxt == eot
            with span("decode.step"):
                logits = M.decode_step(params, cross_kv, cache, nxt, i, config, policy,
                                       valid_from=valid_from, int8_dots=int8_dots)
            steps += 1
            if (step + 1) % _POLL_EVERY == 0:
                with span("decode.poll"):
                    done = bool(finished.all())
                if done:
                    break
    count("decode.steps", steps)
    count("decode.row_steps", steps * b)
    return DecodeResult(tokens=tokens, lengths=lengths, sum_logprobs=sum_logprobs,
                        no_speech_probs=no_speech_probs, steps=steps)
