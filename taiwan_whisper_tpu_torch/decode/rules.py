"""Whisper decoding rules (port of taiwan_whisper_tpu/decode/rules.py:
DecodeRules, apply_rules, _rule_mask, greedy_rules_argmax). The greedy
loop takes the fused ``greedy_rules_argmax``; sampling and beam search
take the masked logits of ``apply_rules``.

The rule state is three values per row — last token, penultimate token,
most recent timestamp — since Whisper timestamps are non-decreasing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..text.tokenizer import BEGIN_SUPPRESS_TOKENS, NON_SPEECH_TOKENS, SpecialTokens

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class DecodeRules:
    """Static decode-rule configuration."""

    vocab_size: int
    eot: int
    timestamp_begin: int
    no_timestamps: int
    no_speech: int = 50362
    timestamps: bool = True
    max_initial_timestamp_index: Optional[int] = 50  # 1.0 s
    suppress_tokens: tuple = tuple(NON_SPEECH_TOKENS)
    begin_suppress_tokens: tuple = tuple(BEGIN_SUPPRESS_TOKENS)

    @classmethod
    def from_special(cls, special: SpecialTokens, timestamps: bool = True,
                     **kw) -> "DecodeRules":
        return cls(
            vocab_size=special.vocab_size,
            eot=special.eot,
            timestamp_begin=special.timestamp_begin,
            no_timestamps=special.no_timestamps,
            no_speech=special.no_speech,
            timestamps=timestamps,
            **kw,
        )

    def suppress_mask(self) -> np.ndarray:
        """[V] bool — True where the token is always suppressed."""
        m = np.zeros((self.vocab_size,), dtype=bool)
        m[[t for t in self.suppress_tokens if t < self.vocab_size]] = True
        if self.timestamps:
            m[self.no_timestamps] = True
        else:
            m[self.timestamp_begin:] = True
        return m

    def begin_suppress_mask(self) -> np.ndarray:
        m = np.zeros((self.vocab_size,), dtype=bool)
        m[[t for t in self.begin_suppress_tokens if t < self.vocab_size]] = True
        return m


def _rule_mask(*, step: int, last_token, penult_token, last_timestamp,
               rules: DecodeRules, suppress, begin_suppress, token_ids):
    """[B, V] bool — True where rules 1-5 suppress the token. ``step`` is
    the host-side sampling step; ``token_ids`` is [1, V]."""
    ts_begin = rules.timestamp_begin
    is_ts_col = token_ids >= ts_begin  # [1, V]
    at_begin = step == 0

    mask = suppress[None, :] | (begin_suppress[None, :] if at_begin else False)
    if not rules.timestamps:
        return mask

    last_was_ts = (last_token >= ts_begin) & (step >= 1)  # [B]
    penult_was_ts = (penult_token >= ts_begin) | (step < 2)
    pair_closed = (last_was_ts & penult_was_ts)[:, None]
    pair_open = (last_was_ts & ~penult_was_ts)[:, None]
    mask = mask | (pair_closed & is_ts_col)
    mask = mask | (pair_open & (token_ids < rules.eot))

    have_ts = (last_timestamp > 0)[:, None]
    floor = torch.where(pair_open[:, 0], last_timestamp, last_timestamp + 1)
    mask = mask | (have_ts & is_ts_col & (token_ids < floor[:, None]))

    if at_begin:
        mask = mask | ~is_ts_col
        if rules.max_initial_timestamp_index is not None:
            mask = mask | (token_ids > ts_begin + rules.max_initial_timestamp_index)
    return mask


def apply_rules(logits: torch.Tensor, *, step: int, last_token, penult_token, last_timestamp,
                rules: DecodeRules, suppress, begin_suppress) -> torch.Tensor:
    """The whole Whisper rule stack on ``logits`` [B, V]: rules 1-5 as
    ``_rule_mask``, then rule 6 (the total timestamp probability beats the
    best text token: force a timestamp). Returns the masked logits [B, V];
    nothing is renormalised."""
    v = rules.vocab_size
    token_ids = torch.arange(v, device=logits.device)[None, :]
    mask = _rule_mask(step=step, last_token=last_token, penult_token=penult_token,
                      last_timestamp=last_timestamp, rules=rules, suppress=suppress,
                      begin_suppress=begin_suppress, token_ids=token_ids)
    logits = logits.masked_fill(mask, NEG_INF)
    if not rules.timestamps:
        return logits
    is_ts_col = token_ids >= rules.timestamp_begin
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(dim=-1)
    force_ts = (ts_logprob > max_text)[:, None]
    return logits.masked_fill(force_ts & ~is_ts_col, NEG_INF)


def greedy_rules_argmax(logits: torch.Tensor, *, step: int, last_token, penult_token,
                        last_timestamp, rules: DecodeRules, suppress, begin_suppress):
    """Rules + argmax + normalised logprob for the greedy loop, in the
    region-wise (max, argmax, logsumexp) form of the JAX package: rule 6's
    force-timestamp comparison is shift-invariant, so the full log_softmax
    reduces to reductions over the text region [0, ts_begin) and the
    timestamp region [ts_begin, V) of the masked logits. Ties between the
    regions go to text (the lower id), as argmax does.

    Returns (next_token [B] int32, logprob [B] fp32)."""
    v = rules.vocab_size
    ts_begin = rules.timestamp_begin
    token_ids = torch.arange(v, device=logits.device)[None, :]
    mask = _rule_mask(step=step, last_token=last_token, penult_token=penult_token,
                      last_timestamp=last_timestamp, rules=rules, suppress=suppress,
                      begin_suppress=begin_suppress, token_ids=token_ids)
    masked = logits.masked_fill(mask, NEG_INF)

    if not rules.timestamps:
        nxt = torch.argmax(masked, dim=-1)
        chosen = masked.gather(-1, nxt[:, None])[:, 0]
        return nxt.to(torch.int32), chosen - torch.logsumexp(masked, dim=-1)

    is_ts_col = token_ids >= ts_begin
    text = masked.masked_fill(is_ts_col, NEG_INF)
    tstamp = masked.masked_fill(~is_ts_col, NEG_INF)
    max_text, arg_text = text.amax(dim=-1), torch.argmax(text, dim=-1)
    max_ts, arg_ts = tstamp.amax(dim=-1), torch.argmax(tstamp, dim=-1)
    lse_text = max_text + torch.log(torch.exp(text - max_text[:, None]).sum(-1))
    lse_ts = max_ts + torch.log(torch.exp(tstamp - max_ts[:, None]).sum(-1))
    force_ts = lse_ts > max_text
    take_ts = force_ts | (max_ts > max_text)  # argmax tie -> text (lower id)
    nxt = torch.where(take_ts, arg_ts, arg_text).to(torch.int32)
    chosen = torch.where(take_ts, max_ts, max_text)
    lse_all = torch.logaddexp(lse_text, lse_ts)
    lse = torch.where(force_ts, lse_ts, lse_all)
    return nxt, chosen - lse
