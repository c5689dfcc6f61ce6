"""Token dictionaries for the melody models.

Parity: transformer_melody/dictionary.py (PAD=0, UNK=1, BOS=2, EOS=3, then
entries). Intentional deviation: the reference shuffles the vocabulary order
at build time and persists it in a pickle (lost from the snapshot); we use a
deterministic order — any checkpoint trained with this framework carries its
own mapping, so only stability matters.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

PAD_TOKEN, UNK_TOKEN, BOS_TOKEN, EOS_TOKEN = "<PAD>", "<UNK>", "<BOS>", "<EOS>"
PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3


@dataclass
class MelodyDictionary:
    entries: tuple = ()
    _idx: dict = field(init=False, repr=False)

    def __post_init__(self):
        self.tokens = [PAD_TOKEN, UNK_TOKEN, BOS_TOKEN, EOS_TOKEN] + \
            [str(e) for e in self.entries]
        self._idx = {t: i for i, t in enumerate(self.tokens)}

    @property
    def size(self) -> int:
        return len(self.tokens)

    @property
    def bos_id(self) -> int:
        return self._idx[BOS_TOKEN]

    @property
    def eos_id(self) -> int:
        return self._idx[EOS_TOKEN]

    def indexer(self, token) -> int:
        return self._idx.get(str(token), UNK_ID)

    def encode(self, seq) -> list[int]:
        return [self.indexer(t) for t in seq]

    def decode_ids(self, ids) -> list[str]:
        return [self.tokens[i] if 0 <= i < len(self.tokens) else UNK_TOKEN
                for i in ids]

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(list(self.entries), f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "MelodyDictionary":
        with open(path, encoding="utf-8") as f:
            return cls(tuple(json.load(f)))


def note_dictionary() -> MelodyDictionary:
    """MIDI pitches 49..81 (parity with Dictionary.build_notes range)."""
    return MelodyDictionary(tuple(range(49, 82)))


def lyric_dictionary_from_chars(chars) -> MelodyDictionary:
    seen, ordered = set(), []
    for c in chars:
        if c not in seen:
            seen.add(c)
            ordered.append(c)
    return MelodyDictionary(tuple(ordered))
