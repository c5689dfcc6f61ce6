"""Mandarin G2P lexicon: one gzipped JSON blob, loaded once per process.

Data parity with the reference's four artifacts (see tools/build_lexicon.py).
Reference behavior being matched: text_normalizers/phoneme_generator.py:17-61.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
from dataclasses import dataclass

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "lexicon.json.gz")


@dataclass(frozen=True)
class Lexicon:
    monosyllable: dict[str, str]          # char -> "pinyin+tone", e.g. "我" -> "wo3"
    polyphone: dict[str, dict[str, list]] # char -> {pronunciation: [phrases...]}
    trad2simp: dict[str, str]             # traditional char -> simplified char
    phone_set: tuple[str, ...]            # 61 toneless phones (VISinger vocab)
    phone_shengdiao_set: tuple[str, ...]  # 247 tone-marked phones

    def to_simplified(self, text: str) -> str:
        """Traditional -> simplified, character-wise."""
        t2s = self.trad2simp
        return "".join(t2s.get(ch, ch) for ch in text)


@functools.lru_cache(maxsize=1)
def load_lexicon(path: str = _DATA_PATH) -> Lexicon:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        blob = json.load(f)
    return Lexicon(
        monosyllable=blob["monosyllable"],
        polyphone=blob["polyphone"],
        trad2simp=blob["trad2simp"],
        phone_set=tuple(blob["phone_set"]),
        phone_shengdiao_set=tuple(blob["phone_shengdiao_set"]),
    )
