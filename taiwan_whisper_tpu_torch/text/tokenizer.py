"""Whisper tokenizer: special-token layout, timestamp tokens, byte-level BPE.

The port's own copy of taiwan_whisper_tpu/text/tokenizer.py: the id layout,
byte-level decode, and the encode side that training uses (GPT-2 BPE over
``vocab.json``/``merges.txt``, ``encode_transcript`` with ``<|..|>``
markers). The GPT-2 pretokenizer is written out by hand over
``unicodedata`` categories instead of the ``regex`` package, which the
machine with the card does not have; it splits text as the JAX package's
``regex`` pattern does (letters and numbers by Unicode 15 categories).
"""

from __future__ import annotations

import dataclasses
import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# 99 Whisper languages in canonical order; token id = SOT + 1 + index.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()
LANGUAGES_V3 = LANGUAGES + ["yue"]

# Standard multilingual generation-time suppress lists (public Whisper
# generation config).
NON_SPEECH_TOKENS = [
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50358, 50359, 50360, 50361,
    50362,
]
BEGIN_SUPPRESS_TOKENS = [220, 50257]  # " " and <|endoftext|>

TIME_PRECISION = 0.02  # seconds per timestamp token step
SAMPLE_RATE = 16000


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Id layout of the multilingual Whisper vocab (51865 / 51866-v3)."""

    eot: int = 50257  # <|endoftext|> (also pad)
    sot: int = 50258  # <|startoftranscript|>
    n_languages: int = 99

    @property
    def translate(self) -> int:
        return self.sot + 1 + self.n_languages

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def start_of_lm(self) -> int:
        return self.transcribe + 1

    @property
    def sot_prev(self) -> int:  # <|startofprev|>
        return self.transcribe + 2

    @property
    def no_speech(self) -> int:  # <|nospeech|>
        return self.transcribe + 3

    @property
    def no_timestamps(self) -> int:  # <|notimestamps|>
        return self.transcribe + 4

    @property
    def timestamp_begin(self) -> int:  # <|0.00|>
        return self.no_timestamps + 1

    @property
    def n_timestamps(self) -> int:
        return 1501  # <|0.00|> .. <|30.00|>

    @property
    def vocab_size(self) -> int:
        return self.timestamp_begin + self.n_timestamps

    def language_id(self, lang: str) -> int:
        langs = LANGUAGES_V3 if self.n_languages == 100 else LANGUAGES
        return self.sot + 1 + langs.index(lang)

    def language_code(self, token_id: int) -> str:
        langs = LANGUAGES_V3 if self.n_languages == 100 else LANGUAGES
        return langs[token_id - self.sot - 1]

    def is_timestamp(self, token_id: int) -> bool:
        return self.timestamp_begin <= token_id < self.timestamp_begin + self.n_timestamps

    def timestamp_seconds(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * TIME_PRECISION

    def seconds_to_timestamp(self, seconds: float) -> int:
        idx = int(round(seconds / TIME_PRECISION))
        idx = max(0, min(idx, self.n_timestamps - 1))
        return self.timestamp_begin + idx


MULTILINGUAL = SpecialTokens()
MULTILINGUAL_V3 = SpecialTokens(eot=50257, sot=50258, n_languages=100)
# English-only models (*.en): GPT-2's vocab keeps <|endoftext|> at 50256,
# so every special sits one lower; sot_sequence(language=None) gives their
# [sot(, notimestamps)] prefix
ENGLISH = SpecialTokens(eot=50256, sot=50257, n_languages=99)


def special_for_vocab(vocab_size: int) -> SpecialTokens:
    """The token layout a checkpoint's vocab size implies (51864: *.en,
    51865: multilingual v1/v2, 51866: the large-v3 family)."""
    if vocab_size == ENGLISH.vocab_size:
        return ENGLISH
    if vocab_size == MULTILINGUAL_V3.vocab_size:
        return MULTILINGUAL_V3
    return MULTILINGUAL


def frames_to_timestamp_str(n_frames: int) -> str:
    """16 kHz audio-frame offset -> '<|T.TT|>' on the 0.02 s (320-sample)
    grid, rounded half to even as the segmenter of the reference rounds it."""
    idx = round(n_frames / int(SAMPLE_RATE * TIME_PRECISION))
    return f"<|{idx * TIME_PRECISION:.2f}|>"


def seconds_to_timestamp_str(seconds: float) -> str:
    return f"<|{round(seconds / TIME_PRECISION) * TIME_PRECISION:.2f}|>"


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_space(ch: str) -> bool:
    """``\\s`` of the ``regex`` package: Unicode White_Space, which leaves
    out the separators U+001C-U+001F that ``str.isspace`` counts."""
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _char_class(ch: str) -> str:
    """'L' (letter), 'N' (number), 'S' (whitespace) or 'O' (other)."""
    if _is_space(ch):
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def pretokenize(text: str) -> List[str]:
    """GPT-2's pretokenizer, the ``regex`` pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    matched left to right by hand."""
    out: List[str] = []
    n, i = len(text), 0
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # ' ?X+' for X in letters, numbers, other: an optional single space
        # and then a run of one class
        j = i + 1 if text[i] == " " and i + 1 < n else i
        cls = _char_class(text[j])
        if cls != "S":
            k = j + 1
            while k < n and _char_class(text[k]) == cls:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # '\s+(?!\S)' keeps the last space of a run for the next word;
        # '\s+' takes a single space before a non-space
        k = i + 1
        while k < n and _is_space(text[k]):
            k += 1
        if k < n and k - i >= 2:
            k -= 1
        out.append(text[i:k])
        i = k
    return out


class WhisperTokenizer:
    """Id-first Whisper tokenizer.

    ``vocab``/``merges`` are optional; without them text encoding is
    unavailable and text ids decode as ``<unk-N>``. Extra added tokens
    (``<|continued|>``) follow the timestamp block.
    """

    CONTINUED = "<|continued|>"

    def __init__(
        self,
        special: SpecialTokens = MULTILINGUAL,
        vocab: Optional[Dict[str, int]] = None,
        merges: Optional[List[Tuple[str, str]]] = None,
        added_tokens: Sequence[str] = (CONTINUED,),
    ):
        self.special = special
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()} if vocab else None
        self.bpe_ranks = (
            {pair: i for i, pair in enumerate(merges)} if merges is not None else None
        )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.added_tokens: Dict[str, int] = {
            tok: special.vocab_size + i for i, tok in enumerate(added_tokens)
        }
        self.inv_added = {v: k for k, v in self.added_tokens.items()}
        self._bpe_cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str,
                   special: SpecialTokens = MULTILINGUAL, **kw) -> "WhisperTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(special=special, vocab=vocab, merges=merges, **kw)

    @classmethod
    def from_pretrained_dir(cls, path: str, **kw) -> "WhisperTokenizer":
        """Load from an HF-style tokenizer dir (vocab.json + merges.txt)."""
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"), **kw)

    def _bpe(self, token: str) -> List[str]:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = list(token)
        if not word:
            return []
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._bpe_cache[token] = word
        return word

    def encode_text(self, text: str) -> List[int]:
        """Plain text -> ids (no special tokens). Requires vocab files."""
        if self.vocab is None or self.bpe_ranks is None:
            raise RuntimeError(
                "text encoding requires vocab.json/merges.txt; construct via "
                "WhisperTokenizer.from_files(...)")
        ids: List[int] = []
        for tok in pretokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab[piece])
        return ids

    def special_token_string(self, token_id: int) -> Optional[str]:
        s = self.special
        if s.is_timestamp(token_id):
            return f"<|{s.timestamp_seconds(token_id):.2f}|>"
        names = {
            s.eot: "<|endoftext|>",
            s.sot: "<|startoftranscript|>",
            s.translate: "<|translate|>",
            s.transcribe: "<|transcribe|>",
            s.start_of_lm: "<|startoflm|>",
            s.sot_prev: "<|startofprev|>",
            s.no_speech: "<|nospeech|>",
            s.no_timestamps: "<|notimestamps|>",
        }
        if token_id in names:
            return names[token_id]
        if s.sot < token_id <= s.sot + s.n_languages:
            return f"<|{s.language_code(token_id)}|>"
        return self.inv_added.get(token_id)

    def sot_sequence(self, language: Optional[str] = "zh", task: str = "transcribe",
                     timestamps: bool = True) -> List[int]:
        """[<|startoftranscript|>, <|lang|>, <|task|>, (<|notimestamps|>)]."""
        s = self.special
        if language is None:
            seq = [s.sot]
        else:
            seq = [s.sot, s.language_id(language),
                   s.transcribe if task == "transcribe" else s.translate]
        if not timestamps:
            seq.append(s.no_timestamps)
        return seq

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True,
               decode_with_timestamps: bool = False) -> str:
        """ids -> text; timestamp/special tokens render as '<|..|>' when asked."""
        s = self.special
        pieces: List[str] = []
        byte_buf: List[str] = []

        def flush():
            if not byte_buf:
                return
            data = bytearray(self.byte_decoder[c] for c in "".join(byte_buf))
            pieces.append(data.decode("utf-8", errors="replace"))
            byte_buf.clear()

        for i in ids:
            i = int(i)
            if i >= s.eot:  # special region
                name = self.special_token_string(i)
                flush()
                if s.is_timestamp(i):
                    if decode_with_timestamps:
                        pieces.append(name)
                elif not skip_special_tokens and name is not None:
                    pieces.append(name)
                elif name is None:
                    pieces.append(f"<unk-{i}>")
                continue
            if self.inv_vocab is not None:
                byte_buf.append(self.inv_vocab.get(i, ""))
            else:
                flush()
                pieces.append(f"<unk-{i}>")
        flush()
        return "".join(pieces)


def strip_markers(text: str) -> str:
    """Remove every '<|...|>' span from a transcript string (an unclosed
    '<|' and what follows it stay)."""
    out: List[str] = []
    i = 0
    while i < len(text):
        j = text.find("<|", i)
        if j < 0:
            out.append(text[i:])
            break
        out.append(text[i:j])
        k = text.find("|>", j + 2)
        if k < 0:
            out.append(text[j:])
            break
        i = k + 2
    return "".join(out)


def parse_timestamp_str(tok: str) -> Optional[float]:
    """'<|1.24|>' -> 1.24; None if not a timestamp marker."""
    if not (tok.startswith("<|") and tok.endswith("|>")):
        return None
    try:
        return float(tok[2:-2])
    except ValueError:
        return None


def _marker_to_id(tok: WhisperTokenizer, marker: str) -> Optional[int]:
    """'<|...|>' string -> token id (timestamps, specials, languages, added)."""
    s = tok.special
    ts = parse_timestamp_str(marker)
    if ts is not None:
        return s.seconds_to_timestamp(ts)
    names = {
        "<|endoftext|>": s.eot,
        "<|startoftranscript|>": s.sot,
        "<|translate|>": s.translate,
        "<|transcribe|>": s.transcribe,
        "<|startoflm|>": s.start_of_lm,
        "<|startofprev|>": s.sot_prev,
        "<|nospeech|>": s.no_speech,
        "<|notimestamps|>": s.no_timestamps,
    }
    if marker in names:
        return names[marker]
    if marker in tok.added_tokens:
        return tok.added_tokens[marker]
    inner = marker[2:-2]
    langs = LANGUAGES_V3 if s.n_languages == 100 else LANGUAGES
    if inner in langs:
        return s.language_id(inner)
    return None


def encode_transcript(tok: WhisperTokenizer, text: str, *, language: str = "zh",
                      task: str = "transcribe", predict_timestamps: bool = True,
                      add_special_tokens: Optional[bool] = None) -> List[int]:
    """Segment-transcript string -> token ids.

    '<|..|>' markers map to their special/timestamp ids; plain text spans go
    through BPE. When the string carries no '<|transcribe|>' marker, the sot
    prefix [sot, lang, task(, notimestamps)] is prepended and <|endoftext|>
    appended.
    """
    if add_special_tokens is None:
        add_special_tokens = "<|transcribe|>" not in text
    ids: List[int] = []
    i = 0
    while i < len(text):
        j = text.find("<|", i)
        if j < 0:
            if text[i:]:
                ids.extend(tok.encode_text(text[i:]))
            break
        if text[i:j]:
            ids.extend(tok.encode_text(text[i:j]))
        k = text.find("|>", j + 2)
        if k < 0:
            ids.extend(tok.encode_text(text[j:]))
            break
        marker = text[j:k + 2]
        mid = _marker_to_id(tok, marker)
        if mid is None:
            ids.extend(tok.encode_text(marker))
        else:
            ids.append(mid)
        i = k + 2
    if add_special_tokens:
        prefix = tok.sot_sequence(language, task, timestamps=predict_timestamps)
        ids = prefix + ids + [tok.special.eot]
    return ids
