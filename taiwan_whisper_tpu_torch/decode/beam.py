"""Batched beam search (port of taiwan_whisper_tpu/decode/beam.py), with
the semantics of HF's BeamSearchScorer:

* a hypothesis scores sum_logprobs / len (HF's default length_penalty
  of 1.0), the length counting the decoder prefix;
* an eot candidate becomes a hypothesis only if it ranks in the top K of
  the 2K candidates of its step;
* an item is done (early_stopping=False) once it holds K hypotheses and
  the best score its alive beams could reach no longer beats the worst of
  them; its hypotheses are then frozen;
* at the end, items that never became done also enter their alive beams.

Beam state lives in [B, K] tensors. The cross K/V is stored once per item
and the K beams fold into the cross kernel's query axis
(``decode_step(beams=K)``). The self cache is [L, B*K, H, Dh, S] in
row-padded storage; each step gathers positions [0, i) of the surviving
beams into a second padded cache and the two swap (``reorder_cache``).
Positions from i on hold nothing yet (the step writes i), so this is the
whole reorder.

Differences from the JAX package, by design:
* the reorder is a gather, not the one-hot product the TPU preferred: it is
  exact either way, and a gather keeps a NaN inside its own beam;
* ``_top_k`` keeps equal values in index order, as ``jax.lax.top_k``
  does (``torch.topk`` promises no order among equals, and at step 0 the
  beams past the first tie); it orders -0.0 below +0.0;
* the loop is a Python loop that polls ``done.all()`` every
  ``_POLL_EVERY`` steps; a done item's hypotheses are frozen, so the steps
  run past that point change nothing.

Spans and counters as in ``greedy.py``: ``decode.select`` holds the
rules, the top-k, the hypothesis bookkeeping and the cache reorder;
``decode.row_steps`` counts the batch's items, not its beams.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..utils.profiling import count, span
from .greedy import cross_kv_mode
from .rules import DecodeRules, apply_rules

NEG_INF = float(np.finfo(np.float32).min) / 2
_POLL_EVERY = 8  # steps between host checks of all(done)


@dataclasses.dataclass
class BeamResult:
    tokens: torch.Tensor  # [B, S] best hypothesis (prefix included, eot-padded)
    scores: torch.Tensor  # [B] its length-penalised score
    all_tokens: torch.Tensor  # [B, K, S] hypotheses, best first
    all_scores: torch.Tensor  # [B, K]
    # the long-form ladder's signals, as greedy.DecodeResult has them
    lengths: torch.Tensor  # [B] sampled non-eot tokens of the best hypothesis
    sum_logprobs: torch.Tensor  # [B] its total logprob, eot included
    no_speech_probs: torch.Tensor  # [B] P(<|nospeech|>) at the sot position
    steps: int  # decode loop iterations run (host-side)


def _top_k(x: torch.Tensor, k: int):
    """The k largest values of fp32 ``x`` along its last axis, largest
    first, equal values in index order (as ``jax.lax.top_k``). Each value
    becomes a unique int64 key, its bits made order-preserving times 2^32
    plus the complement of its index, so ``torch.topk``, which promises no
    order among equals, orders the keys exactly (a stable sort of the whole
    row costs 35x more on the CPU)."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key = key * (1 << 32) + (n - 1 - torch.arange(n, device=x.device))
    idx = (n - 1) - (torch.topk(key, k).values & 0xFFFFFFFF)
    return x.gather(-1, idx), idx


def _gather_beams(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x [B, Kin, ...] reordered along the beam axis by beam_idx [B, Kout]."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(beam_idx.shape + x.shape[2:]))


def reorder_cache(cache: M.KVCache, spare: M.KVCache, rows: torch.Tensor, length: int):
    """Row r of ``spare`` takes row ``rows[r]`` of ``cache`` over positions
    [0, length), for K and V, written in place into spare's padded storage
    (its strides stay). Returns (spare, cache): the reordered cache first."""
    for src, dst in ((cache.k, spare.k), (cache.v, spare.v)):
        torch.index_select(src[..., :length], 1, rows, out=dst[..., :length])
    return spare, cache


@torch.inference_mode()
def beam_decode(params, enc_out: torch.Tensor, prefix: torch.Tensor, config: WhisperConfig,
                rules: DecodeRules, policy: DtypePolicy = DtypePolicy(), *,
                num_beams: int = 5, max_len: Optional[int] = None,
                sot_index: int = 0,
                quantize_cross_kv=0, device=None) -> BeamResult:
    """Beam search over a batch: enc_out [B, T_enc, d], prefix [B, P].
    ``params`` are prepared for ``device`` (cuda unless given; raises when
    CUDA is absent)."""
    dev = resolve_device(device)
    enc_out = enc_out.to(dev)
    prefix = prefix.to(dev)
    b, p_len = prefix.shape
    k = num_beams
    max_len = max_len or config.max_target_positions
    if p_len >= max_len:
        raise ValueError(f"prefix of {p_len} tokens leaves no room below max_len {max_len}")
    eot, ts_begin, vocab = rules.eot, rules.timestamp_begin, rules.vocab_size
    suppress = torch.from_numpy(rules.suppress_mask()).to(dev)
    begin_suppress = torch.from_numpy(rules.begin_suppress_mask()).to(dev)

    quantize, int8_dots = cross_kv_mode(quantize_cross_kv)
    with span("decode.cross_kv"):
        cross_kv = M.precompute_cross_kv(params, enc_out, config, policy, quantize=quantize)
    with span("decode.prefill"):
        cache = M.init_cache(params, config, b * k, max_len, dtype=policy.compute_dtype,
                             device=dev)
        spare = M.init_cache(params, config, b * k, max_len, dtype=policy.compute_dtype,
                             device=dev)
        prefix_rep = prefix.repeat_interleave(k, dim=0)
        logits, sot_logits = M.prefill(params, cross_kv, cache, prefix_rep, config, policy,
                                       aux_index=sot_index, beams=k, int8_dots=int8_dots)
        # the beams are identical at prefill: one no-speech probe per item
        no_speech_probs = torch.softmax(sot_logits[::k], dim=-1)[:, rules.no_speech]

    alive_seq = torch.full((b, k, max_len), eot, dtype=torch.int32, device=dev)
    alive_seq[:, :, :p_len] = prefix_rep.view(b, k, p_len)
    # beam 0 only at step 0: the beams are identical
    alive_logp = torch.tensor([[0.0] + [NEG_INF] * (k - 1)], device=dev).repeat(b, 1)
    alive_ts = torch.zeros((b, k), dtype=torch.int32, device=dev)
    fin_seq = torch.full((b, k, max_len), eot, dtype=torch.int32, device=dev)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    fin_exists = torch.zeros((b, k), dtype=torch.bool, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cand_rank = torch.arange(2 * k, device=dev)[None, :]
    item_base = torch.arange(b, device=dev)[:, None] * k

    steps = 0
    with span("decode.loop"):
        for i in range(p_len, max_len):
            step = i - p_len
            if step and step % _POLL_EVERY == 0:
                with span("decode.poll"):
                    all_done = bool(done.all())
                if all_done:
                    break
            with span("decode.select"):
                flat_seq = alive_seq.view(b * k, max_len)
                # HF log-softmaxes first and masks the normalised scores without
                # renormalising, so each beam's constant does not see the mask
                logprobs = apply_rules(
                    torch.log_softmax(logits, dim=-1), step=step,
                    last_token=flat_seq[:, i - 1], penult_token=flat_seq[:, max(i - 2, 0)],
                    last_timestamp=alive_ts.view(-1), rules=rules, suppress=suppress,
                    begin_suppress=begin_suppress)
                total = logprobs.view(b, k, vocab) + alive_logp[:, :, None]
                cand_logp, cand_idx = _top_k(total.view(b, k * vocab), 2 * k)
                cand_beam, cand_tok = cand_idx // vocab, cand_idx % vocab
                is_eos = cand_tok == eot

                # the hypothesis set: eot candidates ranked in the top K, while
                # the item is not done, scored at the full length i
                hyp_len = float(i)
                eos_ok = is_eos & (cand_rank < k) & ~done[:, None]
                eos_scores = torch.where(eos_ok, cand_logp / hyp_len, NEG_INF)
                merged_seq = torch.cat([fin_seq, _gather_beams(alive_seq, cand_beam)], dim=1)
                merged_exists = torch.cat([fin_exists, eos_ok], dim=1)
                rank_scores = torch.where(merged_exists,
                                          torch.cat([fin_scores, eos_scores], dim=1), NEG_INF)
                fin_scores, top_fin = _top_k(rank_scores, k)
                fin_exists = merged_exists.gather(1, top_fin)
                fin_seq = _gather_beams(merged_seq, top_fin)

                # done: K hypotheses held, and the best candidate cannot beat
                # the worst
                best_attainable = cand_logp.amax(dim=1) / hyp_len
                worst_fin = torch.where(fin_exists, fin_scores, NEG_INF).amin(dim=1)
                done = done | (fin_exists.all(dim=1) & (worst_fin >= best_attainable))

                # the alive set: the best K candidates that are not eot, in order
                alive_rank = torch.where(is_eos, NEG_INF, cand_logp)
                alive_logp, top_alive = _top_k(alive_rank, k)
                new_beam = cand_beam.gather(1, top_alive)
                new_tok = cand_tok.gather(1, top_alive)
                alive_seq = _gather_beams(alive_seq, new_beam)
                alive_seq[:, :, i] = new_tok.to(torch.int32)
                alive_ts = torch.where(new_tok >= ts_begin, new_tok,
                                       alive_ts.gather(1, new_beam)).to(torch.int32)

                cache, spare = reorder_cache(cache, spare, (new_beam + item_base).view(-1), i)
            with span("decode.step"):
                logits = M.decode_step(params, cross_kv, cache, new_tok.view(-1), i, config,
                                       policy, beams=k, int8_dots=int8_dots)
            steps += 1
    count("decode.steps", steps)
    count("decode.row_steps", steps * b)

    # finalisation: items not done enter their alive beams at the final length
    alive_scores = torch.where(done[:, None], NEG_INF, alive_logp / float(p_len + steps))
    merged_exists = torch.cat([fin_exists, (~done[:, None]).expand(b, k)], dim=1)
    rank_scores = torch.where(merged_exists, torch.cat([fin_scores, alive_scores], dim=1),
                              NEG_INF)
    all_scores, order = _top_k(rank_scores, k)
    all_tokens = _gather_beams(torch.cat([fin_seq, alive_seq], dim=1), order)

    # alive beams hold no eot, so a hypothesis' sampled count is its non-eot
    # tail; the total logprob undoes the length normalisation at
    # p_len + sampled, the length its score was divided by
    best = all_tokens[:, 0]
    lengths = (best[:, p_len:] != eot).sum(dim=-1).to(torch.int32)
    sum_logprobs = all_scores[:, 0] * (p_len + lengths).float()
    return BeamResult(tokens=best, scores=all_scores[:, 0], all_tokens=all_tokens,
                      all_scores=all_scores, lengths=lengths, sum_logprobs=sum_logprobs,
                      no_speech_probs=no_speech_probs, steps=steps)
