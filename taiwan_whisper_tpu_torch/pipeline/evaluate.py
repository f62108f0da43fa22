"""Stage 4: evaluation, MER and RTF over a test manifest (port of
taiwan_whisper_tpu/pipeline/evaluate.py).

* short: batches of 30 s windows, log-mel through the kernel, then greedy,
  or beam search with ``num_beams`` > 1;
* sequential and chunked: one long-form decode a file
  (decode/longform.py);
* speculative: each utterance padded or trimmed to 30 s, encoded by the
  teacher and by the assistant (the draft model), then
  ``speculative_decode`` (batch 1, its default of 5 draft tokens a round:
  the CLI sets no other, so ``EvalConfig`` carries no draft count), to the
  teacher's positions;
* metrics: MixErrorRate (separate-language: EN-WER and ZH-CER beside the
  MER), RTF = wall / audio seconds, audio seconds per second.

The ground truth is the first line of the .txt beside each audio file,
markers stripped.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..audio.io import load_audio_16k
from ..audio.manifest import read_manifest
from ..audio.mel import SAMPLE_RATE, pad_or_trim
from ..decode.longform import chunked_decode, decode_audio, sequential_decode
from ..decode.rules import DecodeRules
from ..decode.speculative import speculative_decode
from ..models import whisper as M
from ..models.config import DtypePolicy, WhisperConfig, resolve_device
from ..models.params import prepare_params
from ..ops.mel_kernel import log_mel
from ..text.metrics import MixErrorRate
from ..text.normalizer import BasicTextNormalizer
from ..text.tokenizer import WhisperTokenizer, strip_markers


@dataclasses.dataclass
class EvalConfig:
    # "none": the English-only models' prefix [sot(, notimestamps)]
    language: Optional[str] = "zh"
    task: str = "transcribe"
    mode: str = "short"  # short | sequential | chunked | speculative
    batch_size: int = 16
    num_beams: int = 1

    def __post_init__(self):
        if isinstance(self.language, str) and self.language.lower() in ("none", "en-only", ""):
            self.language = None


@dataclasses.dataclass
class EvalResult:
    mer: float
    en_wer: Optional[float]
    zh_cer: Optional[float]
    rtf: float
    audio_seconds_per_second: float
    n_samples: int
    predictions: List[str]
    references: List[str]


def _decode_short_batch(params, config: WhisperConfig, tok: WhisperTokenizer,
                        rules: DecodeRules, policy: DtypePolicy, cfg: EvalConfig,
                        audio_batch: np.ndarray, device):
    """(tokens [B, S], lengths [B] or None for beam search) of one batch."""
    sot_seq = tok.sot_sequence(cfg.language, cfg.task, timestamps=True)
    prefix = torch.tensor([sot_seq] * audio_batch.shape[0], dtype=torch.int32, device=device)
    res = decode_audio(params, torch.from_numpy(audio_batch).to(device), prefix, config, rules,
                       policy, max_len=config.max_target_positions, num_beams=cfg.num_beams,
                       device=device)
    tokens = res.tokens.cpu().numpy()
    return tokens, None if cfg.num_beams > 1 else res.lengths.cpu().numpy()


def evaluate_manifest(params, config: WhisperConfig, tok: WhisperTokenizer,
                      manifest_path: str, cfg: EvalConfig = EvalConfig(), *,
                      policy: DtypePolicy = DtypePolicy(), output_dir: Optional[str] = None,
                      assistant: Optional[tuple] = None, device=None) -> EvalResult:
    """Decode every file of the manifest in ``cfg.mode`` on ``device`` (cuda
    unless given) and score it; with ``output_dir``, also write
    ``eval_predictions.tsv`` (path, hyp, ref). The speculative mode needs
    ``assistant`` = (params, config) of the draft model."""
    if cfg.mode == "speculative" and assistant is None:
        raise ValueError("mode='speculative' needs assistant=(params, config)")
    if cfg.mode not in ("short", "sequential", "chunked", "speculative"):
        raise ValueError(f"mode must be short, sequential, chunked or speculative, "
                         f"got {cfg.mode!r}")
    dev = resolve_device(device)
    params = prepare_params(params, policy, dev)
    manifest = read_manifest(manifest_path)
    audio_paths = manifest.absolute_paths()
    txt_paths = manifest.transcript_paths()
    rules = DecodeRules.from_special(tok.special, timestamps=True)
    sot_len = len(tok.sot_sequence(cfg.language, cfg.task, timestamps=True))

    predictions: List[str] = []
    audio_seconds = 0.0
    t0 = time.time()
    if cfg.mode == "speculative":
        a_params, a_config = assistant
        a_params = prepare_params(a_params, policy, dev)
        n_window = config.max_source_positions * 2 * 160
        prefix = torch.tensor([tok.sot_sequence(cfg.language, cfg.task, timestamps=True)],
                              dtype=torch.int32, device=dev)
        for p in audio_paths:
            raw = load_audio_16k(p)
            audio_seconds += min(len(raw), n_window) / SAMPLE_RATE
            wave = torch.from_numpy(pad_or_trim(raw, n_window)[None]).to(dev)
            with torch.inference_mode():
                t_enc = M.encode(params, log_mel(wave, config.num_mel_bins), config, policy)
                s_enc = M.encode(a_params, log_mel(wave, a_config.num_mel_bins), a_config,
                                 policy)
            res = speculative_decode(params, config, a_params, a_config, t_enc, s_enc, prefix,
                                     rules, policy, max_len=config.max_target_positions,
                                     device=dev)
            ids = res.tokens[0, sot_len: sot_len + res.length].tolist()
            predictions.append(tok.decode(ids, skip_special_tokens=True))
    elif cfg.mode == "short":
        n_window = config.max_source_positions * 2 * 160
        bs = cfg.batch_size
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            for i in range(0, len(audio_paths), bs):
                paths = audio_paths[i: i + bs]
                raw = list(pool.map(load_audio_16k, paths))
                audio_seconds += sum(min(len(a), n_window) for a in raw) / SAMPLE_RATE
                arrs = [pad_or_trim(a, n_window) for a in raw]
                while len(arrs) < bs:
                    arrs.append(np.zeros_like(arrs[0]))
                tokens, lengths = _decode_short_batch(params, config, tok, rules, policy, cfg,
                                                      np.stack(arrs), dev)
                for j in range(len(paths)):
                    ids = tokens[j][sot_len:]
                    if lengths is not None:
                        ids = ids[: int(lengths[j])]
                    predictions.append(tok.decode(ids.tolist(), skip_special_tokens=True))
    else:
        for p in audio_paths:
            audio = load_audio_16k(p)
            audio_seconds += len(audio) / SAMPLE_RATE
            if cfg.mode == "sequential":
                res = sequential_decode(params, audio, config, tok, policy,
                                        language=cfg.language, task=cfg.task,
                                        num_beams=cfg.num_beams, device=dev)
            else:
                res = chunked_decode(params, audio, config, tok, policy, language=cfg.language,
                                     task=cfg.task, batch_size=cfg.batch_size,
                                     num_beams=cfg.num_beams, device=dev)
            predictions.append(res.text(tok))
    wall = time.time() - t0

    references = []
    for txt in txt_paths:
        with open(txt, encoding="utf-8") as f:
            references.append(strip_markers(f.readline().strip()))
    normalizer = BasicTextNormalizer()
    scores = MixErrorRate(separate_language=True).compute(
        [normalizer(p) for p in predictions], [normalizer(r) for r in references])
    if isinstance(scores, dict):
        mer, en_wer, zh_cer = scores["MER"], scores.get("EN WER"), scores.get("ZH CER")
    else:
        mer, en_wer, zh_cer = float(scores), None, None

    result = EvalResult(
        mer=float(mer), en_wer=en_wer, zh_cer=zh_cer,
        rtf=wall / max(audio_seconds, 1e-9),
        audio_seconds_per_second=audio_seconds / max(wall, 1e-9),
        n_samples=len(predictions), predictions=predictions, references=references)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "eval_predictions.tsv"), "w", encoding="utf-8") as f:
            f.write("path\thyp\tref\n")
            for p, hyp, ref in zip(manifest.paths, predictions, references):
                f.write(f"{p}\t{hyp}\t{ref}\n")
    return result
