"""Speculative (assisted) greedy decoding: a student drafts, the teacher
verifies (port of taiwan_whisper_tpu/decode/speculative.py).

The distilled student drafts k tokens with cached single-token steps, the
teacher scores the chunk of its own pick and the k drafts in ONE
``extend`` pass, and the longest agreeing prefix plus the teacher's next
pick are kept. Greedy-exact: the tokens equal teacher-only greedy decoding
with the same rule stack. Batch 1, as in the JAX package and HF assisted
generation: per-row acceptance does not batch.

The JAX ``lax.while_loop`` becomes a host loop. Each round reads one small
tensor back (the teacher's pick, the drafts and the teacher's choices) to
learn how many drafts it accepts: one device-to-host sync a round. The
tail (the last k + 1 positions, where a draft no longer fits) runs plain
teacher steps with no sync; tokens past an eot are scrubbed at the end, as
the JAX function scrubs them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from .rules import DecodeRules, apply_rules


@dataclasses.dataclass
class SpecDecodeResult:
    tokens: torch.Tensor  # [1, max_len] int32, prefix included, eot past the end
    length: int  # sampled tokens, prefix and eot excluded
    draft_accept_rate: float  # accepted / drafted, as fp32 division
    rounds: int  # teacher extend passes


@torch.inference_mode()
def speculative_decode(teacher_params, teacher_config: WhisperConfig, student_params,
                       student_config: WhisperConfig, teacher_enc: torch.Tensor,
                       student_enc: torch.Tensor, prefix: torch.Tensor, rules: DecodeRules,
                       policy: DtypePolicy = DtypePolicy(), *, num_draft_tokens: int = 5,
                       max_len: Optional[int] = None, device=None) -> SpecDecodeResult:
    """Greedy decode of one utterance with the student drafting
    ``num_draft_tokens`` tokens a round: teacher_enc [1, T, d_teacher],
    student_enc [1, T, d_student] (the same tensor when the encoder is
    shared), prefix [1, P]. Both cross K/V are unquantized. Params are
    prepared for ``device`` (cuda unless given)."""
    dev = resolve_device(device)
    teacher_enc, student_enc, prefix = (x.to(dev) for x in (teacher_enc, student_enc, prefix))
    k = num_draft_tokens
    b, p_len = prefix.shape
    if b != 1:
        raise ValueError(f"speculative decoding takes one utterance, got a batch of {b}")
    max_len = max_len or teacher_config.max_target_positions
    eot, ts_begin = rules.eot, rules.timestamp_begin
    suppress = torch.from_numpy(rules.suppress_mask()).to(dev)
    begin_suppress = torch.from_numpy(rules.begin_suppress_mask()).to(dev)
    dtype = policy.compute_dtype

    t_cross = M.precompute_cross_kv(teacher_params, teacher_enc, teacher_config, policy)
    s_cross = M.precompute_cross_kv(student_params, student_enc, student_config, policy)
    t_cache = M.init_cache(teacher_params, teacher_config, 1, max_len, dtype=dtype, device=dev)
    s_cache = M.init_cache(student_params, student_config, 1, max_len, dtype=dtype, device=dev)
    # the teacher's last prompt position predicts position p_len
    t_logits, _ = M.prefill(teacher_params, t_cross, t_cache, prefix, teacher_config, policy)
    M.prefill(student_params, s_cross, s_cache, prefix, student_config, policy)

    tokens = torch.full((1, max_len), eot, dtype=torch.int32, device=dev)
    tokens[:, :p_len] = prefix

    def pick(logits, i, last_ts):
        """The rule-masked argmax for position ``i`` after tokens[:, :i]."""
        masked = apply_rules(logits, step=i - p_len, last_token=tokens[:, i - 1],
                             penult_token=tokens[:, max(i - 2, 0)], last_timestamp=last_ts,
                             rules=rules, suppress=suppress, begin_suppress=begin_suppress)
        return torch.argmax(masked, dim=-1).to(torch.int32)

    def upd_ts(tok, last_ts):
        return torch.where(tok >= ts_begin, tok, last_ts)

    cur = p_len
    last_ts = torch.zeros(1, dtype=torch.int32, device=dev)
    finished = False
    accepted = drafted = rounds = 0
    while cur < max_len - (k + 1) and not finished:
        # the token at `cur` is the teacher's; the student drafts k after it,
        # each written into `tokens` (positions past the accepted ones are
        # reset below)
        tok0 = pick(t_logits, cur, last_ts)
        tokens[:, cur] = tok0
        last_ts = upd_ts(tok0, last_ts)
        tok, d_ts = tok0, last_ts
        for j in range(k):
            logits = M.decode_step(student_params, s_cross, s_cache, tok, cur + j,
                                   student_config, policy)
            tok = pick(logits, cur + j + 1, d_ts)
            tokens[:, cur + j + 1] = tok
            d_ts = upd_ts(tok, d_ts)
        chunk = tokens[:, cur:cur + k + 1].clone()  # tok0 and the k drafts
        # logits[:, j] predicts position cur + j + 1
        t_all = M.extend(teacher_params, t_cross, t_cache, chunk, cur, teacher_config, policy)
        choices, v_ts = [], last_ts
        for j in range(k):
            c = pick(t_all[:, j], cur + j + 1, v_ts)
            choices.append(c)
            v_ts = upd_ts(c, v_ts)
        # one sync a round: tok0, the drafts and the teacher's choices
        host = torch.cat([chunk[0], *choices]).cpu().numpy()
        draft, choice = host[1:k + 1], host[k + 1:]
        agree = np.append(draft == choice, False)
        n_accept = int(np.argmin(agree))  # the first disagreement
        for j in range(n_accept):  # last_ts over the accepted drafts only
            last_ts = upd_ts(chunk[:, j + 1], last_ts)
        finished = bool(host[0] == eot or (draft[:n_accept] == eot).any())
        cur += 1 + n_accept
        tokens[:, cur:] = eot
        t_logits = t_all[:, n_accept]
        accepted += n_accept
        drafted += k
        rounds += 1

    # the tail: plain teacher steps where a draft no longer fits
    if not finished:
        for i in range(cur, max_len):
            tok = pick(t_logits, i, last_ts)
            tokens[:, i] = tok
            last_ts = upd_ts(tok, last_ts)
            t_logits = M.decode_step(teacher_params, t_cross, t_cache, tok, i,
                                     teacher_config, policy)
        cur = max_len

    row = tokens[0, p_len:].cpu().numpy()
    eots = np.flatnonzero(row == eot)
    length = int(eots[0]) if len(eots) else cur - p_len
    tokens[:, p_len + length:] = eot  # accepted tokens past the eot
    rate = np.float32(accepted) / np.float32(max(drafted, 1))
    return SpecDecodeResult(tokens=tokens, length=length, draft_accept_rate=float(rate),
                            rounds=rounds)
