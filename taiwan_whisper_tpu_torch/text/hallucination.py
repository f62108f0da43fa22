"""Hallucination detectors: n-gram repetition, blocklists, cross-model MER
(port of taiwan_whisper_tpu/text/hallucination.py). They work on strings;
pipeline/prefilter.py puts the files around them.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Iterable, List, Optional, Tuple

from .metrics import MixErrorRate
from .normalizer import BasicTextNormalizer

TIMESTAMP_RE = re.compile(r"<\|\d{1,2}\.\d{2}\|>")


def char_ngram_hallucinated(text: str, n: int = 6, threshold: int = 5) -> bool:
    """True when some character n-gram occurs more than ``threshold`` times
    (n-grams touching '<|' or '|>' are skipped)."""
    if len(text) < n:
        return False
    counts = defaultdict(int)
    for i in range(len(text) - n + 1):
        gram = text[i: i + n]
        if "|>" in gram or "<|" in gram:
            continue
        counts[gram] += 1
    return bool(counts) and max(counts.values()) > threshold


# exact-match words and substrings (or look-around patterns) that mark a
# transcript as a known hallucination
BLOCK_MATCH_LIST = ["Okay.", "...", ".", "Mm."]
BLOCK_CONTAIN_LIST = [
    "請不吝",
    r"(?<!\w)org(?!\w)",
    "點贊",
    "點讚",
    "字幕提供",
    "支持明鏡",
    "點點欄目",
]


def blocklist_hits(normalized_text: str) -> Tuple[List[str], List[str]]:
    """(matched substrings, matched standalone words) of the blocklists in
    normalizer output."""
    contains = [kw for kw in BLOCK_CONTAIN_LIST
                if (re.search(kw, normalized_text) if kw.startswith("(?") or "(?<" in kw
                    else kw in normalized_text)]
    words = re.findall(r"\b\w+\b|\.\.\.|[^\s\w]", normalized_text)
    return contains, [w for w in words if w in BLOCK_MATCH_LIST]


def clean_segment_transcript(transcript: str) -> str:
    """A segment transcript's text: cut at <|endoftext|> and <|continued|>,
    timestamp markers replaced by spaces."""
    t = transcript.strip().split("<|endoftext|>")[0]
    t = t.split("<|continued|>")[0]
    t = TIMESTAMP_RE.sub(" ", t)
    return t.strip().replace("  ", " ")


@dataclasses.dataclass
class FilterDecision:
    index: int
    hallucinated: bool
    mer: Optional[float] = None
    reason: str = ""


class CrossModelFilter:
    """Teacher-vs-validator prefilter: a segment is dropped when the MER
    between its teacher transcript (cleaned, normalized) and the validator's
    hypothesis (normalized; the MER's reference side) exceeds ``threshold``. With
    ``mix_detection`` a teacher text that repeats an n-gram is dropped
    outright, and a validator text that does is kept."""

    def __init__(self, threshold: float = 0.4, mix_detection: bool = False,
                 empty_error_rate: float = 1.0):
        self.threshold = threshold
        self.mix_detection = mix_detection
        self.empty_error_rate = empty_error_rate
        self.metric = MixErrorRate()
        self.normalizer = BasicTextNormalizer()

    def check(self, index: int, teacher_transcript: str, validator_hyp: str) -> FilterDecision:
        teacher = self.normalizer(clean_segment_transcript(teacher_transcript))
        hyp = self.normalizer(validator_hyp.strip())
        if self.mix_detection:
            if char_ngram_hallucinated(teacher):
                return FilterDecision(index, True, reason="teacher-ngram")
            if char_ngram_hallucinated(hyp):
                return FilterDecision(index, False, reason="validator-ngram")
        mer = self.metric.compute([teacher], [hyp], empty_error_rate=self.empty_error_rate)
        return FilterDecision(index, bool(mer > self.threshold), mer=float(mer), reason="mer")

    def check_batch(self, items: Iterable[Tuple[int, str, str]]) -> List[FilterDecision]:
        return [self.check(i, t, h) for i, t, h in items]


def wer_filter_in_range(pred: str, ref: str, metric: MixErrorRate, max_wer_percent: float,
                        normalizer: Optional[BasicTextNormalizer] = None) -> bool:
    """Training-time filter against ground truth: True when the MER of the
    normalized texts, in percent, is below ``max_wer_percent`` (an empty
    reference never passes)."""
    normalizer = normalizer or BasicTextNormalizer()
    p, r = normalizer(pred), normalizer(ref)
    if not r.strip():
        return False
    return float(metric.compute([p], [r])) * 100.0 < max_wer_percent
