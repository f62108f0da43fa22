"""Chunked long-form pieces the labelling driver uses (port of
taiwan_whisper_tpu/decode/longform.py: TranscriptSegment, LongformResult,
_tokens_to_segments, chunk_with_stride). The sequential strategy and the
per-file chunked_decode wait for a later slice."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..audio.mel import SAMPLE_RATE, pad_or_trim
from ..text.tokenizer import TIME_PRECISION, SpecialTokens, WhisperTokenizer


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
