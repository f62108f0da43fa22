"""Whisper's timestamp decoding rules and greedy choice, and the logit gap
that judges a served token.

The rules (OpenAI's ``ApplyTimestampRules`` with the multilingual
generation config): the non-speech tokens and ``<|notimestamps|>`` are
never sampled; " " and ``<|endoftext|>`` not as the first token; the first
token is a timestamp at most 1.0 s; after a closed pair of timestamps
comes text, after an open one a timestamp or ``<|endoftext|>``; a
timestamp never goes below the last one (nor repeats it once a pair is
closed); and when the total probability of the timestamps beats the best
text token, a timestamp is taken. Greedy takes the best timestamp in that
case and the best text token otherwise.

``step_gaps`` reads each served token against the reference's logits: how
far, in logits, the reference would have to move for greedy to pick it.
For a token in the region greedy takes (text or timestamps), that is the
region's best logit less the token's; for one in the other region, add by
how much the timestamps' log-sum-exp misses the best text logit. A served
token that the rules forbid has an infinite gap.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

EOT = 50257
SOT = 50258
NO_SPEECH = 50362
NO_TIMESTAMPS = 50363
TS_BEGIN = 50364
MAX_INITIAL_TS = 50
NON_SPEECH = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50358, 50359, 50360, 50361,
    50362,
)
BEGIN_SUPPRESS = (220, EOT)


def rule_masks(prefix: Sequence[int], served: Sequence[int], vocab: int,
               device) -> torch.Tensor:
    """[S, V] bool: True where the rules forbid the token at each of the
    ``len(served)`` steps, given the tokens served before it."""
    seq = list(prefix) + list(served)
    p = len(prefix)
    n = len(served)
    ids = torch.arange(vocab, device=device)
    is_ts = ids >= TS_BEGIN
    base = torch.zeros(vocab, dtype=torch.bool, device=device)
    base[list(t for t in NON_SPEECH if t < vocab)] = True
    base[NO_TIMESTAMPS] = True
    masks = base.repeat(n, 1)
    last_ts = 0
    for s in range(n):
        i = p + s
        last, penult = seq[i - 1], seq[max(i - 2, 0)]
        m = masks[s]
        if s == 0:
            m[list(BEGIN_SUPPRESS)] = True
        last_was_ts = last >= TS_BEGIN and s >= 1
        penult_was_ts = penult >= TS_BEGIN or s < 2
        if last_was_ts and penult_was_ts:
            m |= is_ts
        if last_was_ts and not penult_was_ts:
            m |= ids < EOT
        if last_ts > 0:
            floor = last_ts if (last_was_ts and not penult_was_ts) else last_ts + 1
            m |= is_ts & (ids < floor)
        if s == 0:
            m |= ~is_ts
            m |= ids > TS_BEGIN + MAX_INITIAL_TS
        if seq[i] >= TS_BEGIN:
            last_ts = seq[i]
    return masks


def _regions(logits: torch.Tensor, masks: torch.Tensor):
    neg = torch.finfo(torch.float32).min
    m = logits.float().masked_fill(masks, neg)
    ts = torch.zeros_like(masks)
    ts[:, TS_BEGIN:] = True
    text = m.masked_fill(ts, neg)
    tstamp = m.masked_fill(~ts, neg)
    return m, text.amax(-1), text.argmax(-1), tstamp.amax(-1), tstamp.argmax(-1), \
        torch.logsumexp(tstamp, -1)


def greedy_picks(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """[S] the token greedy takes at each step: the best timestamp when the
    timestamps' log-sum-exp beats the best text logit, else the best text
    token (ties go to text)."""
    _, max_text, arg_text, _, arg_ts, lse_ts = _regions(logits, masks)
    return torch.where(lse_ts > max_text, arg_ts, arg_text)


def step_gaps(logits: torch.Tensor, masks: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[S] logit gap of each served token (module docstring)."""
    m, max_text, _, max_ts, _, lse_ts = _regions(logits, masks)
    tokens = tokens.long().to(m.device)
    chosen = m.gather(-1, tokens[:, None])[:, 0]
    is_ts = tokens >= TS_BEGIN
    gap = torch.where(is_ts, (max_text - lse_ts).clamp(min=0) + (max_ts - chosen),
                      (lse_ts - max_text).clamp(min=0) + (max_text - chosen))
    forbidden = masks.gather(-1, tokens[:, None])[:, 0]
    return torch.where(forbidden, torch.full_like(gap, float("inf")), gap)


def beam_logprobs(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """[S, V] log-probabilities as beam search scores them: the log-softmax
    of the logits with the rules' tokens at -inf, not renormalised."""
    return torch.log_softmax(logits.float(), -1).masked_fill(masks, float("-inf"))


def served_tokens(tokens: np.ndarray, p_len: int, length: int) -> np.ndarray:
    """The tokens greedy served after the prefix: the sampled ones, and the
    ``<|endoftext|>`` that ended the row when it came before the budget."""
    end = p_len + length + (1 if p_len + length < len(tokens) else 0)
    return np.asarray(tokens[p_len:end], np.int64)
