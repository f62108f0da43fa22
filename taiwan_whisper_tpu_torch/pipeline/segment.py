"""Stage 2a: re-segment long-form pseudo-labels into <=30 s windows
(port of taiwan_whisper_tpu/pipeline/segment.py).

Teacher utterances (start, end, text) from the label CSVs are packed
greedily into windows. When the next utterance would overflow 30 s, the
window is cut at that utterance's start; if more than 1 s of it falls
inside the window, its start tag and ``<|continued|>`` close the window's
text, and the window's text becomes the next window's prompt. The text
after the last cut is not emitted. Timestamps are on the 0.02 s
(320-sample) grid (``frames_to_timestamp_str``). Host code only.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Sequence

import numpy as np

from ..audio.io import write_flac, write_wav
from ..audio.manifest import SegmentText, write_segment_txt
from ..text.tokenizer import frames_to_timestamp_str

SAMPLE_RATE = 16000
SEGMENT_LENGTH = 30 * SAMPLE_RATE
CONTINUED_THRESHOLD_S = 1.0  # append <|continued|> if > 1 s spills in


@dataclasses.dataclass
class Utterance:
    start: float  # seconds
    end: float
    text: str


@dataclasses.dataclass
class Segment:
    """One emitted <=30 s window."""

    start_frame: int
    end_frame: int
    transcript: str  # timestamp-token text incl. <|endoftext|>
    prev_transcript: str  # previous window's transcript (prompt source)


def read_pseudo_label_csv(path: str) -> List[Utterance]:
    """The {start,end,text} CSV a label run writes (header skipped, rows of
    another width ignored)."""
    utts: List[Utterance] = []
    with open(path, encoding="utf-8") as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if len(row) != 3:
                continue
            start, end, text = row
            utts.append(Utterance(float(start), float(end), text.strip()))
    return utts


def segment_utterances(utterances: Sequence[Utterance]) -> List[Segment]:
    """Pack utterances into <=30 s windows. Frames are
    ``int(seconds * SAMPLE_RATE)`` of the CSV's float seconds."""
    if not utterances:
        return []
    segments: List[Segment] = []
    prev_end_frame = int(utterances[0].start * SAMPLE_RATE)
    prev_text = ""
    cur_text = ""
    for utt in utterances:
        s_frame = int(utt.start * SAMPLE_RATE)
        e_frame = int(utt.end * SAMPLE_RATE)
        s_tag = frames_to_timestamp_str(s_frame - prev_end_frame)
        e_tag = frames_to_timestamp_str(e_frame - prev_end_frame)
        if e_frame - prev_end_frame > SEGMENT_LENGTH:
            cur_end_frame = prev_end_frame + SEGMENT_LENGTH
            if cur_end_frame - s_frame > CONTINUED_THRESHOLD_S * SAMPLE_RATE:
                # the cut utterance starts inside this window: mark carry-over
                cur_text += s_tag + "<|continued|>"
            cur_text += "<|endoftext|>"
            segments.append(Segment(start_frame=prev_end_frame, end_frame=s_frame,
                                    transcript=cur_text, prev_transcript=prev_text))
            prev_end_frame = s_frame
            prev_text = cur_text
            cur_text = (frames_to_timestamp_str(0) + utt.text
                        + frames_to_timestamp_str(e_frame - prev_end_frame))
        else:
            cur_text += s_tag + utt.text + e_tag
    return segments


def segment_audio_file(audio: np.ndarray, utterances: Sequence[Utterance], output_dir: str,
                       file_name: str, audio_format: str = "flac") -> List[str]:
    """Write each window's audio and its 2-line txt as
    ``<output_dir>/<file_name>/<file_name>_<start>-<end>.<audio_format>``
    (and ``.txt``); returns the audio paths relative to ``output_dir``."""
    seg_dir = os.path.join(output_dir, file_name)
    os.makedirs(seg_dir, exist_ok=True)
    rel_paths: List[str] = []
    for seg in segment_utterances(utterances):
        base = f"{file_name}_{seg.start_frame}-{seg.end_frame}"
        audio_path = os.path.join(seg_dir, f"{base}.{audio_format}")
        chunk = audio[seg.start_frame: seg.end_frame]
        if audio_format == "flac":
            write_flac(audio_path, chunk, SAMPLE_RATE)
        else:
            write_wav(audio_path, chunk, SAMPLE_RATE)
        write_segment_txt(os.path.join(seg_dir, f"{base}.txt"),
                          SegmentText(transcript=seg.transcript,
                                      prev_transcript=seg.prev_transcript))
        rel_paths.append(os.path.join(file_name, f"{base}.{audio_format}"))
    return rel_paths
