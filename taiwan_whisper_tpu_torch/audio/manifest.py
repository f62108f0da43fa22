"""Manifest and segment-file formats (port of taiwan_whisper_tpu/audio/manifest.py).

* fairseq-style TSV manifest: the first line is the root dir, following
  lines are relative audio paths, optionally "\\t<num_frames>".
* per-segment transcript txt beside each audio file, in either of two
  schemas: 2 lines (transcript / prev-transcript, what the segmenter
  writes) or 5 lines (transcript / blank / end-segment transcript / blank /
  prev). ``read_segment_txt`` reads both into one ``SegmentText``;
  ``write_segment_txt`` writes the 2-line schema.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Manifest:
    root: str
    paths: List[str]
    frames: Optional[List[int]] = None  # per-path sample counts, if known

    def __len__(self) -> int:
        return len(self.paths)

    def absolute_paths(self) -> List[str]:
        return [os.path.join(self.root, p) for p in self.paths]

    def transcript_paths(self) -> List[str]:
        """The segment txt beside each audio file (extension replaced)."""
        return [os.path.join(self.root, os.path.splitext(p)[0] + ".txt")
                for p in self.paths]


def read_manifest(path: str) -> Manifest:
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        paths: List[str] = []
        frames: List[int] = []
        has_frames = True
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            paths.append(parts[0])
            if len(parts) > 1 and parts[1].isdigit():
                frames.append(int(parts[1]))
            else:
                has_frames = False
    return Manifest(root=root, paths=paths,
                    frames=frames if has_frames and frames else None)


def write_manifest(path: str, manifest: Manifest):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        print(manifest.root, file=f)
        for i, p in enumerate(manifest.paths):
            if manifest.frames is not None:
                print(f"{p}\t{manifest.frames[i]}", file=f)
            else:
                print(p, file=f)


def split_valid(manifest: Manifest, valid_percent: float,
                seed: int = 42) -> Tuple[Manifest, Manifest]:
    """Random train/valid split: each path goes to valid when one draw of
    ``random.Random(seed)`` (one per path, in order) is below
    ``valid_percent``."""
    assert 0.0 <= valid_percent <= 0.5
    rng = random.Random(seed)
    idx = list(range(len(manifest.paths)))
    valid_ids = {i for i in idx if rng.random() < valid_percent}

    def pick(ids):
        return Manifest(root=manifest.root, paths=[manifest.paths[i] for i in ids],
                        frames=[manifest.frames[i] for i in ids] if manifest.frames else None)

    return pick([i for i in idx if i not in valid_ids]), pick(sorted(valid_ids))


@dataclasses.dataclass
class SegmentText:
    """One 30 s segment's transcript record.

    transcript: timestamp-token text, ends with <|endoftext|> (and possibly
        <|continued|> before it when the last utterance spans the boundary)
    prev_transcript: previous segment's transcript (prompt source)
    end_transcript: text of the last (possibly continued) utterance; only
        the 5-line schema has it
    """

    transcript: str
    prev_transcript: str = ""
    end_transcript: str = ""


def read_segment_txt(path: str) -> SegmentText:
    """Read either schema, keyed on line count."""
    with open(path, encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f.readlines()]
    if len(lines) >= 5:
        return SegmentText(transcript=lines[0].strip(),
                           end_transcript=lines[2].strip(),
                           prev_transcript=lines[4].strip())
    return SegmentText(transcript=lines[0].strip() if lines else "",
                       prev_transcript=lines[1].strip() if len(lines) > 1 else "")


def write_segment_txt(path: str, seg: SegmentText):
    """Write the 2-line schema: transcript, then prev-transcript."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(seg.transcript + "\n")
        f.write(seg.prev_transcript + "\n")
