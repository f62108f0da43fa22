"""Streaming training dataset over segment manifests + batch collation.

The port's copy of taiwan_whisper_tpu/pipeline/dataset.py (host-side numpy,
no device work): manifest streaming, 2/5-line txt parsing, last-segment
trim/append, <|continued|> prompt cleanup, timestamp and condition-on-prev
sampling, prompt trimming, shift-right and -100 masking. It makes the same
``np.random.RandomState`` draws in the same order as the JAX package, so
its batches are byte-identical to the JAX package's. Audio is WAV or FLAC
(audio/io.py).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..audio.io import load_audio_16k
from ..audio.manifest import Manifest, read_segment_txt
from ..audio.mel import N_SAMPLES, pad_or_trim
from ..text.tokenizer import WhisperTokenizer, encode_transcript

_TS_RE = re.compile(r"<\|\d{1,2}\.\d{2}\|>")
LABEL_IGNORE = -100
WHITESPACE_TOKEN_ID = 220


@dataclasses.dataclass
class SegmentFeature:
    audio: np.ndarray  # float32 16 kHz
    transcript: str  # timestamp text, no <|endoftext|>
    prev_transcript: str  # with <|startofprev|> prefix
    last_segment_transcript: str = ""


def _trim_last_segment(feature: SegmentFeature) -> SegmentFeature:
    """Cut audio+text at the final timestamp: drops the trailing
    <|continued|> partial utterance so labels end at a clean boundary."""
    stamps = _TS_RE.findall(feature.transcript)
    if len(stamps) > 1:
        last = stamps[-1]
        feature.transcript = feature.transcript.split(last)[0] + last
        trim = int(float(last[2:-2]) * 16000)
        if trim < len(feature.audio):
            feature.audio = feature.audio[:trim]
    return feature


def _append_last_segment(feature: SegmentFeature) -> SegmentFeature:
    """Replace the <|continued|> tail with the full last-utterance text."""
    markers = re.findall(r"<\|[\w\.]{1,12}\|>", feature.transcript)
    if "<|continued|>" in markers:
        before = markers[markers.index("<|continued|>") - 1]
        feature.transcript = (
            feature.transcript.split(before)[0] + feature.last_segment_transcript
        )
    return feature


LAST_SEGMENT_HANDLERS = {
    "trim": _trim_last_segment,
    "append": _append_last_segment,
    "none": lambda f: f,
}


def load_segment_feature(audio_path: str, txt_path: str,
                         last_segment_handler: str = "trim") -> SegmentFeature:
    seg = read_segment_txt(txt_path)
    transcript = seg.transcript.split("<|endoftext|>")[0]
    prev = "<|startofprev|>" + seg.prev_transcript.split("<|endoftext|>")[0]
    if "<|continued|>" in prev:
        # strip the continued marker from the prompt, cutting at its last
        # timestamp
        stamps = _TS_RE.findall(prev)
        if len(stamps) > 1:
            prev = prev.split(stamps[-1])[0] + stamps[-1]
        prev = prev.replace("<|continued|>", "")
    feature = SegmentFeature(
        audio=load_audio_16k(audio_path),
        transcript=transcript,
        prev_transcript=prev,
        last_segment_transcript=seg.end_transcript,
    )
    return LAST_SEGMENT_HANDLERS[last_segment_handler](feature)


def stream_segments(manifest: Manifest, last_segment_handler: str = "trim",
                    indices: Optional[Sequence[int]] = None,
                    num_workers: int = 0) -> Iterator[SegmentFeature]:
    """Stream decoded segments in manifest (or ``indices``) order.

    ``num_workers > 0`` decodes ahead on a thread pool with a bounded
    in-flight window, yielding strictly in order.
    """
    audio_paths = manifest.absolute_paths()
    txt_paths = manifest.transcript_paths()
    order = list(indices if indices is not None else range(len(audio_paths)))
    if num_workers <= 0:
        for i in order:
            yield load_segment_feature(audio_paths[i], txt_paths[i], last_segment_handler)
        return

    from concurrent.futures import ThreadPoolExecutor

    window = num_workers * 2
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = [pool.submit(load_segment_feature, audio_paths[i], txt_paths[i],
                               last_segment_handler)
                   for i in order[:window]]
        nxt = window
        for k in range(len(order)):
            feature = pending[k].result()
            pending[k] = None  # free decoded audio once consumed
            if nxt < len(order):
                i = order[nxt]
                pending.append(pool.submit(load_segment_feature, audio_paths[i],
                                           txt_paths[i], last_segment_handler))
                nxt += 1
            yield feature


# ---------------------------------------------------------------------------
# training example construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainPrepConfig:
    language: str = "zh"
    task: str = "transcribe"
    timestamp_probability: float = 0.2
    condition_on_prev_probability: float = 0.2
    round_timestamps: bool = False  # round ts tokens to 0.1 s
    max_label_length: int = 448
    chunk_samples: int = N_SAMPLES  # audio pad/trim length (30 s default)

    @property
    def prompt_cutoff_length(self) -> int:
        return self.max_label_length // 2


def round_timestamp_tokens(text: str, ndigits: int = 1) -> str:
    """'<|6.24|>' -> '<|6.20|>'."""
    def repl(m):
        return "<|{:.2f}|>".format(round(float(m.group(1)), ndigits))

    return re.sub(r"<\|(\d{1,2}\.\d{2})\|>", repl, text)


def build_label_ids(tok: WhisperTokenizer, feature: SegmentFeature,
                    cfg: TrainPrepConfig, rng: np.random.RandomState) -> List[int]:
    """Transcript (+ sampled prompt) -> label id sequence
    [(<|startofprev|> prompt)? sot lang task (notimestamps)? text eot]."""
    special = tok.special
    ts_begin = special.timestamp_begin

    transcript = feature.transcript
    if cfg.round_timestamps:
        transcript = round_timestamp_tokens(transcript)
    token_ids = encode_transcript(tok, transcript, language=cfg.language, task=cfg.task,
                                  predict_timestamps=True)
    has_timestamps = any(t >= ts_begin for t in token_ids)
    predict_timestamps = True
    if has_timestamps:
        predict_timestamps = bool(rng.binomial(1, cfg.timestamp_probability))
        if not predict_timestamps:
            # drop timestamps, insert <|notimestamps|> after [sot, lang, task]
            token_ids = [t for t in token_ids if t < ts_begin]
            token_ids.insert(3, special.no_timestamps)

    prev_ids: Optional[List[int]] = None
    if feature.prev_transcript and len(feature.prev_transcript) > len("<|startofprev|>"):
        if bool(rng.binomial(1, cfg.condition_on_prev_probability)):
            prev_ids = encode_transcript(tok, feature.prev_transcript,
                                         add_special_tokens=False)

    if prev_ids is not None:
        if has_timestamps and not predict_timestamps:
            prev_ids = [t if t < ts_begin else WHITESPACE_TOKEN_ID for t in prev_ids]
        cutoff = cfg.prompt_cutoff_length
        if len(prev_ids) > cutoff:
            prev_ids = [special.sot_prev] + prev_ids[-cutoff + 1:]
        if len(prev_ids) + len(token_ids) > cfg.max_label_length:
            trim = len(prev_ids) + len(token_ids) - cfg.max_label_length + 1
            prev_ids = [special.sot_prev] + prev_ids[trim:]
        token_ids = prev_ids + token_ids
    return token_ids[: cfg.max_label_length]


def collate_batch(features: np.ndarray, label_ids: Sequence[Sequence[int]], sot_id: int,
                  pad_id: int, max_label_length: int = 448,
                  features_key: str = "mel") -> Dict[str, np.ndarray]:
    """labels -> (decoder_input_ids, labels) with shift-right, pad- and
    prompt-masking. ``features``: [B, frames, n_mels] mel or [B, samples]
    raw audio."""
    b = len(label_ids)
    u = max_label_length
    padded = np.full((b, u), pad_id, np.int32)
    attn = np.zeros((b, u), bool)
    for i, ids in enumerate(label_ids):
        n = min(len(ids), u)
        padded[i, :n] = ids[:n]
        attn[i, :n] = True
    decoder_input_ids = padded[:, :-1].copy()
    labels = padded[:, 1:].astype(np.int32)
    mask = attn[:, 1:]
    labels = np.where(mask, labels, LABEL_IGNORE)
    # mask prompt tokens: everything up to and including the sot token
    is_sot = labels == sot_id
    has_sot = is_sot.any(axis=1)
    bos_index = np.argmax(is_sot, axis=1)
    bos_index = np.where(bos_index > 0, bos_index + 1, bos_index)
    prompt_mask = np.arange(labels.shape[1])[None, :] < bos_index[:, None]
    labels = np.where(prompt_mask & has_sot[:, None], LABEL_IGNORE, labels)
    return {features_key: features, "decoder_input_ids": decoder_input_ids,
            "labels": labels}


def train_batches(manifest: Manifest, tok: WhisperTokenizer, cfg: TrainPrepConfig,
                  batch_size: int, *, seed: int = 0, last_segment_handler: str = "trim",
                  shuffle: bool = True, mel_fn=None, drop_last: bool = True,
                  num_workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Stream shuffled, collated training batches from a segment manifest.

    With ``mel_fn=None`` (the distill driver's way) batches carry raw audio
    under ``"audio"`` and the log-mel runs on the device; a ``mel_fn`` maps
    the stacked host audio to features under ``"mel"``.
    """
    rng = np.random.RandomState(seed)
    order = np.arange(len(manifest))
    if shuffle:
        rng.shuffle(order)
    buf_audio: List[np.ndarray] = []
    buf_labels: List[List[int]] = []

    def collate():
        audio = np.stack(buf_audio)
        feats = mel_fn(audio) if mel_fn is not None else audio
        return collate_batch(np.asarray(feats), buf_labels, tok.special.sot,
                             tok.special.eot, cfg.max_label_length,
                             features_key="mel" if mel_fn is not None else "audio")

    for feature in stream_segments(manifest, last_segment_handler, order.tolist(),
                                   num_workers=num_workers):
        buf_audio.append(pad_or_trim(feature.audio.astype(np.float32), cfg.chunk_samples))
        buf_labels.append(build_label_ids(tok, feature, cfg, rng))
        if len(buf_audio) == batch_size:
            yield collate()
            buf_audio, buf_labels = [], []
    if buf_audio and not drop_last:
        yield collate()
