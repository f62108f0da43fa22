"""Long-form (> 30 s) transcription, sequential and chunked (port of
taiwan_whisper_tpu/decode/longform.py).

``sequential_decode`` slides a 30 s window over the log-mel of the whole
file (computed once, through the mel kernel, over the audio and 30 s of
zeros), with the OpenAI/HF temperature-fallback ladder: beam search (or
greedy) at t = 0, sampling above it, the compression-ratio, logprob and
no-speech rules, and the previous window's text as a prompt while the
chosen temperature stays below 0.5. ``chunked_decode`` cuts the audio
into strided 30 s chunks, decodes them in batches and keeps each chunk's
segments that start inside its core. The host does the window arithmetic;
the device does mel, encode and decode. Samples come from a
``torch.Generator`` seeded from ``seed`` (the JAX package threads a PRNG
key: the streams differ by design).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.mel import SAMPLE_RATE, pad_or_trim
from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..models.params import prepare_params
from ..ops.mel_kernel import log_mel
from ..text.tokenizer import TIME_PRECISION, SpecialTokens, WhisperTokenizer
from ..utils.profiling import span
from .beam import beam_decode
from .greedy import greedy_decode
from .rules import DecodeRules


@dataclasses.dataclass
class TranscriptSegment:
    start: float  # absolute seconds
    end: float
    token_ids: List[int]  # text tokens only (no timestamps/specials)
    raw_token_ids: Optional[List[int]] = None  # the sampled slice incl. timestamps

    def text(self, tokenizer: WhisperTokenizer) -> str:
        return tokenizer.decode(self.token_ids, skip_special_tokens=True)


@dataclasses.dataclass
class LongformResult:
    segments: List[TranscriptSegment]

    def text(self, tokenizer: WhisperTokenizer) -> str:
        return "".join(s.text(tokenizer) for s in self.segments)


def _compression_ratio(data: bytes) -> float:
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _tokens_to_segments(
    tokens: Sequence[int],
    special: SpecialTokens,
    window_offset: float,
    window_duration: float,
) -> Tuple[List[TranscriptSegment], float, bool]:
    """Split a window's sampled tokens into timestamped segments.

    Returns (segments, seek_advance_seconds, ended_with_single_timestamp),
    with the OpenAI/HF window-consumption rules: segment boundaries are
    consecutive timestamp pairs; a single trailing timestamp consumes the
    whole window; with pairs but no single trailing timestamp the seek
    advances to the last complete segment; with no pairs the whole
    decoding is one segment.
    """
    tokens = list(tokens)
    tb = special.timestamp_begin
    is_ts = [t >= tb for t in tokens]
    segments: List[TranscriptSegment] = []

    single_ending = len(tokens) >= 2 and not is_ts[-2] and is_ts[-1]
    slices = [i + 1 for i in range(len(tokens) - 1) if is_ts[i] and is_ts[i + 1]]

    def emit(start_tok: int, end_tok: int, raw: Sequence[int]):
        segments.append(
            TranscriptSegment(
                start=window_offset + special.timestamp_seconds(start_tok),
                end=window_offset + special.timestamp_seconds(end_tok),
                token_ids=[t for t in raw if t < special.eot],
                raw_token_ids=list(raw),
            )
        )

    if slices:
        if single_ending:
            slices.append(len(tokens))
        else:
            slices[-1] += 1  # include the duplicated closing timestamp
        last_slice = 0
        for i, cur in enumerate(slices):
            seg = tokens[last_slice:cur]
            is_last = i == len(slices) - 1
            start_tok = seg[0] if seg[0] >= tb else tb
            end_tok = seg[-1] if (not is_last or single_ending) else seg[-2]
            emit(start_tok, end_tok if end_tok >= tb else tb, seg)
            last_slice = cur
        if single_ending:
            return segments, window_duration, True
        advance = special.timestamp_seconds(tokens[last_slice - 2])
        return segments, max(advance, TIME_PRECISION), False

    ts_in = [t for t in tokens if t >= tb]
    end = window_duration
    if ts_in and ts_in[-1] != tb:
        end = special.timestamp_seconds(ts_in[-1])
    if tokens:
        segments.append(
            TranscriptSegment(
                start=window_offset,
                end=window_offset + end,
                token_ids=[t for t in tokens if t < special.eot],
                raw_token_ids=tokens,
            )
        )
    return segments, window_duration, single_ending


def chunk_with_stride(
    audio: np.ndarray,
    chunk_s: float = 30.0,
    stride_left_s: float = 5.0,
    stride_right_s: float = 5.0,
) -> List[Tuple[np.ndarray, float, float, float]]:
    """(chunk audio padded to chunk_s, offset_s, stride_left_s,
    stride_right_s) per chunk; step = chunk - strideL - strideR."""
    chunk_len = int(chunk_s * SAMPLE_RATE)
    step = chunk_len - int((stride_left_s + stride_right_s) * SAMPLE_RATE)
    assert step > 0
    out = []
    pos = 0
    total = len(audio)
    while True:
        start = max(pos - int(stride_left_s * SAMPLE_RATE), 0) if pos > 0 else 0
        chunk = audio[start: start + chunk_len]
        is_first = start == 0
        is_last = start + chunk_len >= total
        sl = 0.0 if is_first else stride_left_s
        sr = 0.0 if is_last else stride_right_s
        out.append((pad_or_trim(chunk.astype(np.float32), chunk_len),
                    start / SAMPLE_RATE, sl, sr))
        if is_last:
            break
        pos = start + chunk_len - int(stride_right_s * SAMPLE_RATE)
    return out


def decode_audio(params, audio: torch.Tensor, prefix: torch.Tensor, config: WhisperConfig,
                 rules: DecodeRules, policy: DtypePolicy, *, max_len=None, quantize_kv=0,
                 num_beams: int = 1, mel_fn=None, device=None):
    """One device batch of fp32 audio [B, N]: log-mel (the kernel, or
    ``mel_fn(audio)`` when given) -> encode -> beam search when
    ``num_beams`` > 1, else greedy. Spans ``decode.mel`` and ``decode.encode``
    (``utils/profiling.py``), then those of the decoder."""
    with span("decode.mel"):
        mel = mel_fn(audio) if mel_fn is not None else log_mel(audio, config.num_mel_bins)
    with span("decode.encode"), torch.inference_mode():
        enc = M.encode(params, mel, config, policy)
    if num_beams > 1:
        return beam_decode(params, enc, prefix, config, rules, policy, num_beams=num_beams,
                           max_len=max_len, quantize_cross_kv=quantize_kv, device=device)
    return greedy_decode(params, enc, prefix, config, rules, policy, max_len=max_len,
                         quantize_cross_kv=quantize_kv, device=device)


def _prompt_from_segments(segments: Sequence[TranscriptSegment], special: SpecialTokens,
                          max_prompt_tokens: int) -> List[int]:
    """The previous windows' tokens as a prompt, as HF builds it: each
    segment's raw tokens (timestamps included) less a duplicated closing
    timestamp, the last ``max_prompt_tokens`` of them after <|startofprev|>."""
    tb = special.timestamp_begin
    out: List[int] = []
    for s in segments:
        raw = s.raw_token_ids if s.raw_token_ids is not None else s.token_ids
        if len(raw) > 2 and raw[-2] >= tb:
            raw = raw[:-1]  # the segment ended with two timestamps: keep one
        out.extend(raw)
    return [special.sot_prev] + out[-max_prompt_tokens:]


def sequential_decode(
    params,
    audio: np.ndarray,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    policy: DtypePolicy = DtypePolicy(),
    *,
    language: Optional[str] = "zh",
    task: str = "transcribe",
    temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_prev: bool = True,
    seed: int = 0,
    quantize_cross_kv=0,
    num_beams: int = 1,
    device=None,
    stats: Optional[dict] = None,
) -> LongformResult:
    """Sequential long-form decode of one 16 kHz fp32 stream, segment and
    seek for seek as HF's long-form generate. The log-mel is taken once
    over the audio and one window of zeros, and windows are sliced in
    frames. Each window is encoded once; each ladder rung decodes it (beam
    search at t = 0 when ``num_beams`` > 1, else greedy or sampled).
    ``stats``, when given, gets ``windows``, ``decodes`` and the longest
    prefix decoded (``max_prefix``)."""
    dev = resolve_device(device)
    params = prepare_params(params, policy, dev)
    special = tokenizer.special
    rules = DecodeRules.from_special(special, timestamps=True)
    n_window_frames = config.max_source_positions * 2  # 3000 for 30 s models
    frames_per_s = SAMPLE_RATE // 160  # 100
    # HF's prompt cut-off: 223 tokens at 448 positions
    max_prompt_tokens = config.max_target_positions // 2 - 1

    # the features: one pass over the audio and one window of zeros
    content_frames = len(audio) // 160
    padded = np.zeros((content_frames + n_window_frames) * 160, np.float32)
    padded[: len(audio)] = audio
    mel_full = log_mel(torch.from_numpy(padded[None]).to(dev), config.num_mel_bins)
    generator = torch.Generator(device=dev).manual_seed(seed)
    stats = {} if stats is None else stats
    stats.update(windows=0, decodes=0, max_prefix=0)

    sot_seq = tokenizer.sot_sequence(language, task, timestamps=True)
    seek = 0  # in mel frames, as HF and OpenAI seek
    all_segments: List[TranscriptSegment] = []
    do_condition = False  # True after the first window, when enabled

    while seek < content_frames:
        seek_num_frames = min(content_frames - seek, n_window_frames)
        window_duration = seek_num_frames / frames_per_s
        window = mel_full[:, seek: seek + n_window_frames]
        if seek_num_frames < n_window_frames:
            # HF zero-pads the last window's features (OpenAI would keep
            # the log-mel of the zero audio)
            window = window.clone()
            window[:, seek_num_frames:] = 0.0
        with torch.inference_mode():
            enc = M.encode(params, window, config, policy)
        stats["windows"] += 1

        if condition_on_prev and do_condition and all_segments:
            prefix_list = _prompt_from_segments(all_segments, special,
                                                max_prompt_tokens) + sot_seq
            sot_index = len(prefix_list) - len(sot_seq)
        else:
            prefix_list = list(sot_seq)
            sot_index = 0
        prefix = torch.tensor([prefix_list], dtype=torch.int32, device=dev)
        budget = config.max_target_positions - len(prefix_list)
        stats["max_prefix"] = max(stats["max_prefix"], len(prefix_list))

        chosen_tokens: List[int] = []
        chosen_temperature = 0.0
        for temperature in temperatures:
            if num_beams > 1 and float(temperature) == 0.0:
                res = beam_decode(params, enc, prefix, config, rules, policy,
                                  num_beams=num_beams, sot_index=sot_index, quantize_cross_kv=quantize_cross_kv,
                                  device=dev)
            else:
                res = greedy_decode(params, enc, prefix, config, rules, policy,
                                    temperature=float(temperature), generator=generator,
                                    sot_index=sot_index,
                                    quantize_cross_kv=quantize_cross_kv, device=dev)
            stats["decodes"] += 1
            toks = res.tokens[0].cpu().numpy()
            n_sampled = int(res.lengths[0])
            sampled = toks[len(prefix_list): len(prefix_list) + n_sampled].tolist()
            finished = n_sampled < budget  # <|endoftext|> was emitted
            # HF averages over the sampled tokens and the eot when there is one
            n_scored = min(n_sampled + 1, budget)
            avg_logprob = float(res.sum_logprobs[0]) / max(n_scored, 1)
            chosen_temperature = float(temperature)

            needs_fallback = False
            if compression_ratio_threshold is not None:
                # HF compresses the token bytes (2 a token for Whisper's
                # vocab), eot included, not the decoded text
                byte_len = int(np.log2(special.vocab_size) / 8) + 1
                scored = sampled + ([special.eot] if finished else [])
                token_bytes = b"".join(int(t).to_bytes(byte_len, "little") for t in scored)
                if _compression_ratio(token_bytes) > compression_ratio_threshold:
                    needs_fallback = True
            if logprob_threshold is not None and avg_logprob < logprob_threshold:
                needs_fallback = True
            if (no_speech_threshold is not None
                    and float(res.no_speech_probs[0]) > no_speech_threshold
                    and (logprob_threshold is None or avg_logprob < logprob_threshold)):
                chosen_tokens = []  # confident silence: skip the window
                break
            chosen_tokens = sampled
            if not needs_fallback:
                break

        # only low-temperature output conditions the next window (HF:
        # condition_on_prev_tokens and temperature < 0.5)
        do_condition = condition_on_prev and chosen_temperature < 0.5

        if not chosen_tokens:
            seek += seek_num_frames
            continue

        segments, advance_s, _ = _tokens_to_segments(
            chosen_tokens, special, seek / frames_per_s, window_duration)
        all_segments.extend(segments)
        advance_frames = int(round(advance_s * frames_per_s))
        # a degenerate zero advance must not hang the loop (beyond HF)
        seek += advance_frames if advance_frames > 0 else seek_num_frames

    return LongformResult(segments=all_segments)


def chunked_decode(
    params,
    audio: np.ndarray,
    config: WhisperConfig,
    tokenizer: WhisperTokenizer,
    policy: DtypePolicy = DtypePolicy(),
    *,
    language: Optional[str] = "zh",
    task: str = "transcribe",
    batch_size: int = 8,
    chunk_s: Optional[float] = None,
    stride_s: Optional[float] = None,
    quantize_cross_kv=0,
    num_beams: int = 1,
    max_decode_tokens: Optional[int] = None,  # cap sampled tokens per chunk
    device=None,
) -> LongformResult:
    """Batched chunked decode with the stride merge: each chunk keeps the
    segments that start inside its core [stride_left, chunk - stride_right);
    the margins belong to its neighbours. A short last batch repeats its
    last chunk. ``num_beams`` > 1 decodes every chunk with beam search."""
    dev = resolve_device(device)
    params = prepare_params(params, policy, dev)
    special = tokenizer.special
    rules = DecodeRules.from_special(special, timestamps=True)
    sot_seq = tokenizer.sot_sequence(language, task, timestamps=True)
    if chunk_s is None:
        chunk_s = config.max_source_positions * 2 * 160 / SAMPLE_RATE
    if stride_s is None:
        stride_s = chunk_s / 6.0  # the reference's default

    chunks = chunk_with_stride(audio, chunk_s, stride_s, stride_s)
    max_len = len(sot_seq) + max_decode_tokens if max_decode_tokens else None
    prefix = torch.tensor([sot_seq] * batch_size, dtype=torch.int32, device=dev)

    all_segments: List[TranscriptSegment] = []
    for i in range(0, len(chunks), batch_size):
        batch = chunks[i: i + batch_size]
        arr = np.stack([c[0] for c in batch] + [batch[-1][0]] * (batch_size - len(batch)))
        res = decode_audio(params, torch.from_numpy(arr).to(dev), prefix, config, rules, policy,
                           max_len=max_len, quantize_kv=quantize_cross_kv, num_beams=num_beams,
                           device=dev)
        tokens = res.tokens.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        for j, (_, offset, sl, sr) in enumerate(batch):
            sampled = tokens[j][len(sot_seq): len(sot_seq) + int(lengths[j])].tolist()
            window_dur = min(chunk_s, len(audio) / SAMPLE_RATE - offset)
            segs, _, _ = _tokens_to_segments(sampled, special, offset, window_dur)
            lo, hi = offset + sl, offset + chunk_s - sr
            for s in segs:
                if (s.start >= lo or sl == 0.0) and (s.start < hi or sr == 0.0):
                    all_segments.append(s)
    all_segments.sort(key=lambda s: s.start)
    return LongformResult(segments=all_segments)
