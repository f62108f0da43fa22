"""Speaker-aware utterance packing and batched short-form pseudo-labelling
(port of taiwan_whisper_tpu/pipeline/packing.py).

``pack_utterances`` concatenates consecutive utterances of one speaker up
to 30 s, as the reference's distributed labeller does before decoding
(training/run_pseudo_labelling.py concatenate_dataset:644-734): a pack
closed by the length limit (the same speaker continuing) is flagged
``condition_on_prev=1``, one closed by a speaker change 0.

``label_packed`` greedy-decodes the packs in batches on the device through
``decode/longform.py::decode_audio`` (log-mel, encode, the greedy loop
over an unquantized cross K/V), with the sot prefix only, zero-audio pad
rows in a short last batch, and the CSV flushed every ``logging_steps``
batches (reference eval_step_with_save:884-952).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..audio.mel import pad_or_trim
from ..decode.longform import decode_audio
from ..decode.rules import DecodeRules
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..models.params import prepare_params
from ..text.tokenizer import WhisperTokenizer


@dataclasses.dataclass
class Utterance:
    audio: np.ndarray
    text: str = ""
    speaker_id: Optional[str] = None


@dataclasses.dataclass
class PackedSample:
    audio: np.ndarray
    text: str
    speaker_id: Optional[str]
    condition_on_prev: int  # 1 when the previous pack is the same speaker


def pack_utterances(
    utterances: Sequence[Utterance],
    max_input_samples: int = 30 * 16000,
) -> List[PackedSample]:
    """Greedy same-speaker packing to < ``max_input_samples``. The reference's
    loop exactly: a length split flags 1, a speaker change 0, both carry the
    next utterance's ``speaker_id``, and the pack still open at the end is
    flushed with 0."""
    if not utterances:
        return []
    packed: List[PackedSample] = []
    audio_sample = utterances[0].audio
    text_sample = utterances[0].text
    cur_speaker = utterances[0].speaker_id

    for idx in range(1, len(utterances)):
        utt = utterances[idx]
        prev_speaker = utterances[idx - 1].speaker_id
        if len(audio_sample) + len(utt.audio) < max_input_samples:
            if utt.speaker_id == prev_speaker:
                audio_sample = np.concatenate([audio_sample, utt.audio])
                text_sample = text_sample + " " + utt.text if text_sample else utt.text
            else:
                packed.append(PackedSample(audio_sample, text_sample, utt.speaker_id, 0))
                audio_sample = utt.audio
                text_sample = utt.text
                cur_speaker = utt.speaker_id
        else:
            packed.append(PackedSample(audio_sample, text_sample, utt.speaker_id, 1))
            audio_sample = utt.audio
            text_sample = utt.text
            cur_speaker = utt.speaker_id
    packed.append(PackedSample(audio_sample, text_sample, cur_speaker, 0))
    return packed


def label_packed(
    params,
    config: WhisperConfig,
    tok: WhisperTokenizer,
    packs: Sequence[PackedSample],
    output_csv: str,
    policy: DtypePolicy = DtypePolicy(),
    *,
    language: str = "zh",
    batch_size: int = 16,
    timestamps: bool = True,
    logging_steps: int = 10,
    mel_fn=None,
    device=None,
) -> List[str]:
    """Batched greedy labelling of packs on ``device`` (cuda unless given) ->
    transcripts, to the model's ``max_target_positions``. CSV rows (id,
    condition_on_prev, whisper_transcript, text) are flushed every
    ``logging_steps`` batches and once at the end (reference :927-952).
    ``mel_fn(audio)`` replaces the log-mel kernel when given."""
    dev = resolve_device(device)
    params = prepare_params(params, policy, dev)
    rules = DecodeRules.from_special(tok.special, timestamps=timestamps)
    n_window = config.max_source_positions * 2 * 160
    sot_seq = tok.sot_sequence(language, "transcribe", timestamps=timestamps)

    os.makedirs(os.path.dirname(os.path.abspath(output_csv)), exist_ok=True)
    transcripts: List[str] = []
    rows: List[List] = []
    wrote_header = False

    def flush():
        nonlocal wrote_header, rows
        mode = "a" if wrote_header else "w"
        with open(output_csv, mode, encoding="utf-8", newline="") as f:
            w = csv.writer(f)
            if not wrote_header:
                w.writerow(["id", "condition_on_prev", "whisper_transcript", "text"])
                wrote_header = True
            w.writerows(rows)
        rows = []

    prefix = torch.tensor([sot_seq] * batch_size, dtype=torch.int32, device=dev)
    for bi, i in enumerate(range(0, len(packs), batch_size)):
        batch = packs[i : i + batch_size]
        arrs = [pad_or_trim(p.audio.astype(np.float32), n_window) for p in batch]
        arrs += [np.zeros_like(arrs[0])] * (batch_size - len(arrs))
        res = decode_audio(params, torch.from_numpy(np.stack(arrs)).to(dev), prefix, config,
                           rules, policy, mel_fn=mel_fn, device=dev)
        tokens = res.tokens.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        for j, pack in enumerate(batch):
            ids = tokens[j][len(sot_seq) : len(sot_seq) + int(lengths[j])]
            text = tok.decode(ids.tolist(), skip_special_tokens=True,
                              decode_with_timestamps=timestamps)
            transcripts.append(text)
            rows.append([
                pack.speaker_id if pack.speaker_id is not None else i + j,
                pack.condition_on_prev, text, pack.text,
            ])
        if (bi + 1) % logging_steps == 0:
            flush()
    flush()
    return transcripts
