"""Mixed Error Rate (MER) for code-switched zh/en transcripts (port of
taiwan_whisper_tpu/text/metrics.py).

Chinese is scored per character (after conversion to simplified), English
per word; both go into one unit sequence whose edit distance over the
reference length is the MER. Options: per-language rates, the S/D/I
decomposition, repetitive-hallucination counts, phonemes from lexicons
(PER), and ``empty_error_rate`` when the reference side has no unit.

The edit distance runs in the repository's C++ helper
(``utils/native.py::edit_distance``, built with g++ at first use; a failed
build raises). ``edit_distance_py`` is its plain version, held against it
in the tests.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..utils.native import edit_distance
from .zh import S2TConverter, T2SConverter

# punctuation / separator characters that end a unit
_SKIP_CHARS = set(
    " \t\n\r,.!?。，！？、；：「」『』（）()[]{}<>《》“”‘’…—～·•"
) | {"\\"}
_TONE_MARKS = {"ˊ", "ˇ", "ˋ", "˙"}


def _is_cjk(ch: str) -> bool:
    return "一" <= ch <= "鿿"


def edit_distance_py(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, two-row DP (the plain version of
    ``utils/native.py::edit_distance``)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_ops(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(S, D, I, N): substitutions, deletions and insertions along one
    backtrace of the full DP (diagonal first, then deletion), and the
    reference length."""
    n, m = len(ref), len(hyp)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1,
                           dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]))
    i, j = n, m
    s = d = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            s += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            d += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return s, d, ins, n


def count_repetitive_hallucination(text: str, n: int = 6, repeat: int = 5,
                                   reset_len: int = 100) -> int:
    """Rolling character-n-gram counter: one count each time an n-gram
    reaches ``repeat`` (the counts then restart), the counts also restarting
    every ``reset_len`` positions; n-grams touching '<|' or '|>' are
    skipped."""
    count = 0
    counts: Dict[str, int] = defaultdict(int)
    if len(text) < n:
        return 0
    prev_reset = 0
    for i in range(len(text) - n + 1):
        gram = text[i: i + n]
        if "|>" in gram or "<|" in gram:
            continue
        counts[gram] += 1
        if counts[gram] >= repeat:
            count += 1
            counts = defaultdict(int)
        if i - prev_reset >= reset_len:
            counts = defaultdict(int)
            prev_reset = i
    return count


@dataclasses.dataclass
class MerBreakdown:
    mer: float
    en_wer: Optional[float] = None
    zh_cer: Optional[float] = None
    substitutions: Optional[int] = None
    deletions: Optional[int] = None
    insertions: Optional[int] = None
    ref_units: Optional[int] = None
    hyp_repetitions: Optional[int] = None
    ref_repetitions: Optional[int] = None


class MixErrorRate:
    """Code-switch metric: zh characters (converted) and en words as units."""

    def __init__(self, to_simplified_chinese: bool = True,
                 to_traditional_chinese: bool = False, phonemize: bool = False,
                 separate_language: bool = False,
                 count_repetitive_hallucination: bool = False,
                 calculate_complete_mer: bool = False, lexicon_path: Optional[str] = None,
                 zh_lexicon_path: Optional[str] = None):
        if to_simplified_chinese and to_traditional_chinese:
            raise ValueError("cannot convert to both simplified and traditional")
        self.converter = None
        if to_simplified_chinese or phonemize:
            self.converter = T2SConverter()
        elif to_traditional_chinese:
            self.converter = S2TConverter()
        if phonemize and separate_language:
            raise NotImplementedError("separate_language incompatible with phonemize")
        self.phonemize = phonemize
        self.separate_language = separate_language
        self.count_repetitions = count_repetitive_hallucination
        self.calculate_complete_mer = calculate_complete_mer
        self._zh_phonemizer = None
        self._en_lexicon: Dict[str, List[str]] = {}
        if phonemize:
            self._init_phonemizers(lexicon_path, zh_lexicon_path)

    def _init_phonemizers(self, lexicon_path: Optional[str],
                          zh_lexicon_path: Optional[str]):
        """zh: a char -> reading TSV (char \\t space-separated symbols), else
        pypinyin's bopomofo when it imports; en: a word -> phonemes TSV."""
        if zh_lexicon_path:
            table: Dict[str, List[str]] = {}
            with open(zh_lexicon_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        table[parts[0]] = parts[1].split()

            def table_phonemize(text: str) -> List[str]:
                return [p for ch in text for p in table.get(ch, [])]

            self._zh_phonemizer = table_phonemize
        else:
            try:
                from pypinyin import Style, lazy_pinyin
            except Exception as e:
                raise RuntimeError(
                    "phonemize=True requires pypinyin or an explicit zh_lexicon_path "
                    "(char\\treading TSV); use MER/CER modes otherwise") from e
            self._zh_phonemizer = partial(lazy_pinyin, style=Style.BOPOMOFO, errors="ignore")
        if lexicon_path:
            with open(lexicon_path, encoding="utf-8") as f:
                for line in f:
                    word, phonemes = line.strip().split("\t")
                    self._en_lexicon[word] = phonemes.split()

    def units(self, text: str) -> List[str]:
        """Mixed unit list: zh single characters (converted), en words;
        other characters are dropped."""
        out: List[str] = []
        word = ""
        for ch in text:
            if ch in _SKIP_CHARS:
                if word:
                    out.append(word)
                    word = ""
                continue
            if _is_cjk(ch):
                if word:
                    out.append(word)
                    word = ""
                if self.converter is not None:
                    ch = self.converter.convert(ch)
                out.append(ch)
            elif ch.isalnum() or ch in ("'", "-"):
                word += ch
        if word:
            out.append(word)
        return out

    def _phonemized(self, units: List[str]) -> List[str]:
        phonemes: List[str] = []
        zh_run: List[str] = []

        def flush_zh():
            if zh_run:
                phns = "".join(self._zh_phonemizer("".join(zh_run)))
                phonemes.extend(p for p in phns if p not in _TONE_MARKS)
                zh_run.clear()

        for u in units:
            if _is_cjk(u[0]):
                zh_run.append(u)
            else:
                flush_zh()
                phonemes.extend(self._en_lexicon.get(u, []))
        flush_zh()
        return phonemes

    def compute(self, predictions: Sequence[str], references: Sequence[str],
                empty_error_rate: float = 1.0, detailed: bool = False,
                **_) -> Union[float, Dict[str, float], MerBreakdown]:
        tot_err = tot_ref = 0
        en_err = en_ref = zh_err = zh_ref = 0
        hyp_rep = ref_rep = 0
        S = D = I = N = 0
        for pred, ref in zip(predictions, references):
            if self.count_repetitions:
                hyp_rep += count_repetitive_hallucination(pred)
                ref_rep += count_repetitive_hallucination(ref)
            p_units = self.units(pred)
            r_units = self.units(ref)
            if self.phonemize:
                p_units = self._phonemized(p_units)
                r_units = self._phonemized(r_units)
            if self.calculate_complete_mer or detailed:
                s, d, ins, n = edit_ops(r_units, p_units)
                S, D, I, N = S + s, D + d, I + ins, N + n
            if self.separate_language:
                en_p = [u for u in p_units if not _is_cjk(u[0])]
                en_r = [u for u in r_units if not _is_cjk(u[0])]
                zh_p = [u for u in p_units if _is_cjk(u[0])]
                zh_r = [u for u in r_units if _is_cjk(u[0])]
                en_err += edit_distance(en_p, en_r)
                en_ref += len(en_r)
                zh_err += edit_distance(zh_p, zh_r)
                zh_ref += len(zh_r)
            tot_err += edit_distance(p_units, r_units)
            tot_ref += len(r_units)

        if tot_ref == 0:
            return empty_error_rate
        mer = tot_err / tot_ref
        if detailed:
            sep = self.separate_language
            return MerBreakdown(
                mer=mer,
                en_wer=(en_err / en_ref if en_ref else 0.0) if sep else None,
                zh_cer=(zh_err / zh_ref if zh_ref else 0.0) if sep else None,
                substitutions=S, deletions=D, insertions=I, ref_units=N,
                hyp_repetitions=hyp_rep if self.count_repetitions else None,
                ref_repetitions=ref_rep if self.count_repetitions else None)
        if self.separate_language or self.count_repetitions:
            result: Dict[str, float] = {"MER": mer}
            if self.separate_language:
                result["EN WER"] = en_err / en_ref if en_ref else 0.0
                result["ZH CER"] = zh_err / zh_ref if zh_ref else 0.0
            if self.count_repetitions:
                result["Hyp Repetitive Hallucination Count"] = hyp_rep
                result["Ref Repetitive Hallucination Count"] = ref_rep
            return result
        return mer
