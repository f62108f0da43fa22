"""Stage 2b: prefiltering — the validator transcribes every 30 s segment and
the cross-model MER filter drops the segments whose teacher transcript it
contradicts (port of taiwan_whisper_tpu/pipeline/prefilter.py).

``validator_transcribe`` greedy-decodes this process's contiguous shard of
the segments (``parallel.host_local_slice``: all of them outside a
multi-process run) in batches of ``batch_size`` on the device: log-mel (the
CUDA kernel on the card), encode, and the greedy loop with an unquantized
cross K/V and a budget of ``max_decode_len`` tokens, prefix included. The
last batch is padded with zero audio to the full batch, as the JAX package
pads it. ``run_prefilter`` writes each rank's ``idx_hyp.<rank>.txt``,
waits for every rank at a barrier, and rank 0 merges every
``idx_hyp.*.txt`` of the output directory; ``filter_manifest`` (host only)
then writes ``hallucination_result.csv`` and the cleaned manifest.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.io import load_audio_16k
from ..audio.manifest import Manifest, read_manifest, write_manifest
from ..audio.mel import pad_or_trim
from ..decode.rules import DecodeRules
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..models.params import prepare_params
from ..parallel import mesh
from ..text.hallucination import CrossModelFilter, FilterDecision
from ..text.tokenizer import WhisperTokenizer
from .label import decode_audio


@dataclasses.dataclass
class PrefilterConfig:
    language: str = "zh"
    batch_size: int = 16
    max_decode_len: int = 448  # tokens per segment, the sot prefix included
    threshold: float = 0.4  # MER above which a segment is dropped
    mix_detection: bool = False
    empty_error_rate: float = 1.0


def validator_decode(params, config: WhisperConfig, tok: WhisperTokenizer,
                     audio_paths: Sequence[str], cfg: PrefilterConfig = PrefilterConfig(),
                     policy: DtypePolicy = DtypePolicy(), *, device=None,
                     stats: Optional[dict] = None) -> List[Tuple[int, np.ndarray, int]]:
    """Greedy-decode this process's shard of the segments (each padded or
    trimmed to the model's 30 s window) on ``device`` (cuda unless given).
    Returns, per segment, (its index in ``audio_paths``, the token row after
    the sot prefix, the count of sampled tokens before eot). Each batch's
    files load on 4 threads. ``stats``, when given, receives the run's
    counts and times."""
    dev = resolve_device(device)
    params = prepare_params(params, policy, dev)
    rules = DecodeRules.from_special(tok.special, timestamps=True)
    sot_seq = tok.sot_sequence(cfg.language, "transcribe", timestamps=True)
    n_window = config.max_source_positions * 2 * 160
    bs = cfg.batch_size
    prefix = torch.tensor([sot_seq] * bs, dtype=torch.int32, device=dev)
    shard = range(len(audio_paths))[mesh.host_local_slice(len(audio_paths))]
    counts = dict(segments=len(shard), batches=0, pad_rows=0,
                  steps=cfg.max_decode_len - len(sot_seq), load_wait_s=0.0, decode_s=0.0,
                  batch_decode_s=[])
    t0 = time.perf_counter()

    def load(i):
        return pad_or_trim(load_audio_16k(audio_paths[i]), n_window)

    out: List[Tuple[int, np.ndarray, int]] = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, len(shard), bs):
            ids = shard[start:start + bs]
            tl = time.perf_counter()
            arrs = list(pool.map(load, ids))
            counts["load_wait_s"] += time.perf_counter() - tl
            counts["pad_rows"] += bs - len(ids)
            arrs += [np.zeros_like(arrs[0])] * (bs - len(ids))
            td = time.perf_counter()
            res = decode_audio(params, torch.from_numpy(np.stack(arrs)).to(dev), prefix,
                               config, rules, policy, max_len=cfg.max_decode_len,
                               quantize_kv=0, device=dev)
            tokens = res.tokens[:, len(sot_seq):].cpu().numpy()
            lengths = res.lengths.cpu().numpy()
            counts["batch_decode_s"].append(time.perf_counter() - td)
            counts["decode_s"] += counts["batch_decode_s"][-1]
            counts["batches"] += 1
            out.extend((i, tokens[j], int(lengths[j])) for j, i in enumerate(ids))
    counts["wall_s"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(counts)
    return out


def validator_transcribe(params, config: WhisperConfig, tok: WhisperTokenizer,
                         audio_paths: Sequence[str], cfg: PrefilterConfig = PrefilterConfig(),
                         policy: DtypePolicy = DtypePolicy(), *, device=None,
                         stats: Optional[dict] = None) -> List[Tuple[int, str]]:
    """[(segment index, the validator's text)]: ``validator_decode``'s
    sampled tokens decoded with the special and timestamp tokens left out."""
    return [(i, tok.decode(row[:n].tolist(), skip_special_tokens=True))
            for i, row, n in validator_decode(params, config, tok, audio_paths, cfg, policy,
                                              device=device, stats=stats)]


def write_hyps_tsv(path: str, hyps: Sequence[Tuple[int, str]]):
    """One ``idx\\thyp`` line per segment; a tab inside a hyp becomes a
    space (a newline is written as it is)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for idx, hyp in hyps:
            f.write(f"{idx}\t{hyp.replace(chr(9), ' ')}\n")


def read_hyps_tsv(paths: Sequence[str]) -> Dict[int, str]:
    """Merge hyp TSVs (per-rank shards); a line that is not ``int\\ttext``
    is counted as invalid and skipped; a later index overrides."""
    merged: Dict[int, str] = {}
    invalid = 0
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                items = line.rstrip("\n").split("\t")
                if len(items) != 2:
                    invalid += 1
                    continue
                try:
                    merged[int(items[0])] = items[1]
                except ValueError:
                    invalid += 1
    if invalid:
        print(f"[prefilter] invalid hyp lines skipped: {invalid}")
    return merged


def filter_manifest(manifest: Manifest, hyps: Dict[int, str],
                    cfg: PrefilterConfig = PrefilterConfig(),
                    output_dir: Optional[str] = None) -> Tuple[Manifest, List[FilterDecision]]:
    """The cross-model filter over every segment with a hyp (in index
    order): returns (the manifest of the kept segments, the decisions), and
    with ``output_dir`` writes ``hallucination_result.csv`` and
    ``train_non-hallucinated-threshold<T>[-mix_detection].tsv`` there."""
    txt_paths = manifest.transcript_paths()
    checker = CrossModelFilter(threshold=cfg.threshold, mix_detection=cfg.mix_detection,
                               empty_error_rate=cfg.empty_error_rate)
    decisions: List[FilterDecision] = []
    for idx, hyp in sorted(hyps.items()):
        with open(txt_paths[idx], encoding="utf-8") as f:
            transcript = f.readline()
        decisions.append(checker.check(idx, transcript, hyp))
    kept = [d.index for d in decisions if not d.hallucinated]
    cleaned = Manifest(root=manifest.root, paths=[manifest.paths[i] for i in kept],
                       frames=[manifest.frames[i] for i in kept] if manifest.frames else None)
    n_bad = sum(d.hallucinated for d in decisions)
    print(f"[prefilter] hallucinated: {n_bad}/{len(decisions)} "
          f"({n_bad / max(len(decisions), 1):.1%})")
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "hallucination_result.csv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["index", "path", "hallucinated", "mer", "reason"])
            for d in decisions:
                w.writerow([d.index, manifest.paths[d.index], int(d.hallucinated),
                            "" if d.mer is None else f"{d.mer:.4f}", d.reason])
        name = f"train_non-hallucinated-threshold{cfg.threshold}"
        if cfg.mix_detection:
            name += "-mix_detection"
        write_manifest(os.path.join(output_dir, f"{name}.tsv"), cleaned)
    return cleaned, decisions


def run_prefilter(manifest_path: str, validator_model_dir: str, output_dir: str,
                  cfg: PrefilterConfig = PrefilterConfig(), tokenizer_dir: Optional[str] = None,
                  *, policy: DtypePolicy = DtypePolicy(), device=None,
                  stats: Optional[dict] = None) -> Manifest:
    """CLI entry: the validator over this process's shard of the
    manifest's segments, its ``idx_hyp.<rank>.txt`` written; after every
    rank has written, rank 0 merges every shard and applies the filter.
    Returns the cleaned manifest on rank 0 and the manifest read on the
    others. ``stats`` as in ``validator_decode``, plus, on rank 0, the
    filter's seconds and counts."""
    from ..models.io import load_model

    dev = resolve_device(device)
    params, config = load_model(validator_model_dir)
    tok = (WhisperTokenizer.from_pretrained_dir(tokenizer_dir)
           if tokenizer_dir else WhisperTokenizer())
    manifest = read_manifest(manifest_path)
    stats = {} if stats is None else stats
    hyps_local = validator_transcribe(params, config, tok, manifest.absolute_paths(), cfg,
                                      policy, device=dev, stats=stats)
    write_hyps_tsv(os.path.join(output_dir, f"idx_hyp.{mesh.rank()}.txt"), hyps_local)
    stats["device"] = str(dev)
    mesh.barrier("prefilter_shards_written")  # every shard is on disk
    if not mesh.is_main():
        return manifest
    tf = time.perf_counter()
    shards = sorted(glob.glob(os.path.join(output_dir, "idx_hyp.*.txt")))
    cleaned, decisions = filter_manifest(manifest, read_hyps_tsv(shards), cfg, output_dir)
    stats.update(filter_s=time.perf_counter() - tf, decisions=len(decisions),
                 hallucinated=sum(d.hallucinated for d in decisions), kept=len(cleaned))
    return cleaned
