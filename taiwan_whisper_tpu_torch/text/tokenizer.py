"""Whisper tokenizer: the id layout and decode side that labelling uses.

The port's own copy of taiwan_whisper_tpu/text/tokenizer.py (special-token
layout, timestamp tokens, byte-level decode). Text *encoding* (BPE merges)
is not on the labelling path and waits for the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence

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


MULTILINGUAL = SpecialTokens()


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


class WhisperTokenizer:
    """Id-first Whisper tokenizer (decode side).

    ``vocab`` is optional; without it text ids render as ``<unk-N>``.
    Extra added tokens (``<|continued|>``) follow the timestamp block.
    Decoding needs only the vocab; BPE merges (text encoding) wait for the
    training slice.
    """

    CONTINUED = "<|continued|>"

    def __init__(
        self,
        special: SpecialTokens = MULTILINGUAL,
        vocab: Optional[Dict[str, int]] = None,
        added_tokens: Sequence[str] = (CONTINUED,),
    ):
        self.special = special
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()} if vocab else None
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.added_tokens: Dict[str, int] = {
            tok: special.vocab_size + i for i, tok in enumerate(added_tokens)
        }
        self.inv_added = {v: k for k, v in self.added_tokens.items()}

    @classmethod
    def from_pretrained_dir(cls, path: str, **kw) -> "WhisperTokenizer":
        """Load the vocab of an HF-style tokenizer dir (vocab.json)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            return cls(vocab=json.load(f), **kw)

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
