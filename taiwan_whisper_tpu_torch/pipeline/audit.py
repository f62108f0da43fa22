"""Hallucination audit sampler: human-listening QA for the prefilter (port
of taiwan_whisper_tpu/pipeline/audit.py).

Samples up to N segments that the prefilter dropped (a seeded numpy
permutation), copies their audio into ``audio_samples/`` and writes one
TSV row per sample, in index order, with the teacher transcript (markers
stripped) beside the validator's hypothesis and, given
``hallucination_result.csv``, the MER and the reason of the drop. Reads
either segment-txt schema. Host code only.
"""

from __future__ import annotations

import csv
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..audio.manifest import read_manifest, read_segment_txt
from .prefilter import read_hyps_tsv

_TS_RE = re.compile(r"<\|\d{1,2}\.\d{2}\|>")


def teacher_text_for_audit(transcript: str, end_transcript: str = "") -> str:
    """Plain teacher text for the audit row: drop <|endoftext|>,
    drop the <|continued|> tail marker, strip every timestamp token
    (reference collect_hallucinations.py:55-62)."""
    text = transcript.split("<|endoftext|>")[0].split("<|continued|>")[0]
    text = _TS_RE.sub(" ", text + " " + end_transcript if end_transcript else text)
    return re.sub(r"\s{2,}", " ", text).strip()


def read_filter_csv(path: str) -> Dict[int, Tuple[str, str]]:
    """hallucination_result.csv -> {index: (mer, reason)}."""
    out: Dict[int, Tuple[str, str]] = {}
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            out[int(row["index"])] = (row.get("mer", ""), row.get("reason", ""))
    return out


def collect_hallucinations(
    original_tsv: str,
    cleaned_tsv: str,
    hyp_tsvs: Sequence[str],
    output_dir: str,
    num_samples: int = 1000,
    seed: int = 0,
    filter_csv: Optional[str] = None,
    copy_audio: bool = True,
) -> str:
    """Sample dropped chunks for human audit; returns the output CSV path.

    original_tsv/cleaned_tsv: manifests before/after the prefilter;
    hyp_tsvs: validator idx\thyp files (per-rank shards accepted).
    """
    original = read_manifest(original_tsv)
    kept = set(read_manifest(cleaned_tsv).paths)
    dropped: List[Tuple[int, str]] = [
        (i, p) for i, p in enumerate(original.paths) if p not in kept
    ]
    hyps = read_hyps_tsv(list(hyp_tsvs))
    diag = read_filter_csv(filter_csv) if filter_csv else {}

    order = np.random.RandomState(seed).permutation(len(dropped))
    picked = [dropped[i] for i in order[:num_samples]]

    os.makedirs(output_dir, exist_ok=True)
    sample_dir = os.path.join(output_dir, "audio_samples")
    if copy_audio:
        os.makedirs(sample_dir, exist_ok=True)
    out_csv = os.path.join(
        output_dir, f"hallucinations_ex{num_samples}_seed{seed}.csv"
    )
    header = ["index_in_origin", "audio_fpath", "trans_text",
              "small_model_trans_text"]
    if diag:
        header += ["mer", "reason"]
    rows: List[List] = []
    txt_paths = original.transcript_paths()
    for idx, rel_path in picked:
        seg = read_segment_txt(txt_paths[idx])
        teacher_text = teacher_text_for_audit(seg.transcript, seg.end_transcript)
        fname = os.path.basename(rel_path)
        if copy_audio:
            shutil.copyfile(
                os.path.join(original.root, rel_path),
                os.path.join(sample_dir, f"{idx}_{fname}"),
            )
        row: List = [idx, fname, teacher_text, hyps.get(idx, "")]
        if diag:
            mer, reason = diag.get(idx, ("", ""))
            row += [mer, reason]
        rows.append(row)
    rows.sort(key=lambda r: r[0])
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(header)
        w.writerows(rows)
    print(f"[audit] sampled {len(rows)}/{len(dropped)} dropped chunks "
          f"-> {out_csv}")
    return out_csv
