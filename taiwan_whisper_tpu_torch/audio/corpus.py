"""Corpus bookkeeping: faculty categorization and duration distributions
(port of taiwan_whisper_tpu/audio/corpus.py; host code only).

Re-implements the reference's 60 k-hour corpus organization tools
(dataset/data_utils.py:7-48 — NTU course-ID faculty codes;
dataset/prepare_dataset.py:25-75 — categorize_audio/analyze_categories;
dataset/analyze_distribution.py; check_duration.py) as pure functions over
explicit mappings instead of print-driven scripts that move files in place.

A course ID ("sid") looks like ``<faculty_char><digits>_<section>``; the
first character selects the faculty bucket (K2D.pdf Table 1 reports hours
per bucket). Video IDs map to course IDs through a ``vid,cid,sid`` CSV.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import shutil
from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from .io import load_audio_16k

# faculty code -> human name (reference: dataset/data_utils.py:7-27)
FACULTY_CODES: Dict[str, str] = {
    "0": "General Education",
    "1": "Liberal Arts",
    "2": "Science",
    "3": "Social Science",
    "4": "Medicine",
    "5": "Engineering",
    "6": "Bio-resource and Agriculture",
    "7": "Management",
    "8": "Public Health",
    "9": "EECS",
    "A": "Law School",
    "B": "Life Science",
    "E": "Continuing Education Division",
    "K": "Advanced Technology",
    "F": "D-school",
    "H": "D-school",
    "Z": "D-school",
    "P": "Program",
    "Q": "Academic Writing Center",
}

UNKNOWN = "unknown"


def category_names() -> List[str]:
    """Bucket directory names: '<char>00' per faculty + 'unknown'."""
    return [f"{c}00" for c in FACULTY_CODES] + [UNKNOWN]


def normalize_sid(raw_sid: Optional[str]) -> Optional[str]:
    """Strip LMS prefixes: 'x:SID:y' -> 'SID', 'x:SID' -> 'SID'."""
    if raw_sid is None:
        return None
    items = raw_sid.split(":")
    if len(items) == 3:
        return items[1]
    return items[-1]


def is_valid_sid(sid: Optional[str]) -> bool:
    if not sid:
        return False
    items = sid.split("_")
    if len(items) != 2 or not items[0]:
        return False
    return items[0][0] in FACULTY_CODES


def sid_category(sid: Optional[str]) -> str:
    """Faculty bucket for a course ID ('900' for EECS etc., else 'unknown')."""
    if is_valid_sid(sid):
        return f"{sid[0]}00"
    return UNKNOWN


def read_vid_to_sid(path: str, normalized: bool = True) -> Dict[str, str]:
    """vid,cid,sid CSV (header skipped; malformed rows ignored)."""
    out: Dict[str, str] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if len(row) != 3:
                continue
            vid, _cid, sid = row
            out[vid] = normalize_sid(sid) if normalized else sid
    return out


def read_sid_to_course_name(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader, None)
        for row in reader:
            if len(row) < 2:
                continue
            out[row[0]] = row[1]
    return out


@dataclasses.dataclass
class CategorizeResult:
    moved: Dict[str, str]  # src path -> dst path
    categories: Dict[str, int]  # category -> file count
    unknown_vids: List[str]


def categorize_corpus(
    audio_paths: Iterable[str],
    output_dir: str,
    vid_to_sid: Mapping[str, str],
    move: bool = False,
) -> CategorizeResult:
    """Place audio files into faculty buckets under ``output_dir``.

    ``move=False`` (default) only computes the layout; ``move=True``
    relocates files like the reference's os.rename pass
    (dataset/prepare_dataset.py:55-59) but across filesystems too.
    """
    moved: Dict[str, str] = {}
    counts: Dict[str, int] = defaultdict(int)
    unknown: List[str] = []
    for cat in category_names():
        os.makedirs(os.path.join(output_dir, cat), exist_ok=True)
    for src in sorted(audio_paths):
        vid = os.path.basename(src).split(".")[0]
        sid = vid_to_sid.get(vid)
        if sid is None:
            unknown.append(vid)
        cat = sid_category(sid)
        dst = os.path.join(output_dir, cat, os.path.basename(src))
        moved[src] = dst
        counts[cat] += 1
        if move:
            shutil.move(src, dst)
    return CategorizeResult(
        moved=moved, categories=dict(counts), unknown_vids=unknown
    )


def category_time_distribution(
    output_dir: str,
    tsv_path: Optional[str] = None,
    ext: str = "flac",
) -> Dict[str, float]:
    """Seconds of audio per faculty bucket (reference analyze_categories:
    dataset/prepare_dataset.py:61-75 + categories.tsv side file)."""
    dist: Dict[str, float] = {}
    rows: List[Tuple[str, str, float]] = []
    for cat in category_names():
        seconds = 0.0
        cat_dir = os.path.join(output_dir, cat)
        if os.path.isdir(cat_dir):
            for name in sorted(os.listdir(cat_dir)):
                if not name.endswith("." + ext):
                    continue
                path = os.path.join(cat_dir, name)
                dur = len(load_audio_16k(path)) / 16000.0
                seconds += dur
                rows.append((cat, path, dur))
        dist[cat] = seconds
    if tsv_path:
        with open(tsv_path, "w") as f:
            for cat, path, dur in rows:
                f.write(f"{cat}\t{path}\t{dur:.3f}\n")
    return dist
