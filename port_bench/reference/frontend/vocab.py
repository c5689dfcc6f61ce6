"""Phoneme vocabularies and id mapping.

Two vocabularies are used by the SVS stack (parity with the reference):
  * PhonemeVocab over VISinger/phone_set.json (61 toneless phones) and
    phone_shengdiao_set.json (247 tone-marked phones), with 3 reserved ids
    (<pad>=0, <EOS>=1, <UNK>=2) prepended — matching TokenTextEncoder
    (VISinger/utils/text_encoder.py:157-209) including the ve->ue / vn->un /
    van->uan spelling canonicalization at encode time.
  * PhonemeSeqEncoder: the standalone 247-symbol per-character encoder used by
    the lyric pipelines (text_normalizers/format_phoneme_seq.py:7-49).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .lexicon import load_lexicon

PAD, EOS, UNK = "<pad>", "<EOS>", "<UNK>"
RESERVED = (PAD, EOS, UNK)

SHENG_MU = frozenset([
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j", "q", "x",
    "z", "c", "s", "y", "w", "zh", "ch", "sh", "r",
])


def split_syllable(syllable: str) -> tuple[str, ...]:
    """Split a pinyin syllable into (initial, final) or a single unit."""
    if syllable[:2] in SHENG_MU:
        return (syllable[:2], syllable[2:]) if syllable[2:] else (syllable[:2],)
    if syllable[:1] in SHENG_MU and syllable[1:]:
        return (syllable[:1], syllable[1:])
    return (syllable,)


@dataclass
class PhonemeVocab:
    tokens: tuple[str, ...]
    _ids: dict[str, int] = field(init=False, repr=False)

    def __post_init__(self):
        full = list(RESERVED) + [t for t in self.tokens if t not in RESERVED]
        self._ids = {t: i for i, t in enumerate(full)}
        self._tokens = full

    @property
    def size(self) -> int:
        return len(self._tokens)

    @staticmethod
    def canonicalize(token: str) -> str:
        return token.replace("ve", "ue").replace("vn", "un").replace("van", "uan")

    def encode(self, s: str) -> list[int]:
        """Space-separated token string -> ids. OOV raises KeyError (parity)."""
        return [self._ids[self.canonicalize(t)] for t in s.strip().split()]

    def contains(self, token: str) -> bool:
        return self.canonicalize(token) in self._ids

    def decode(self, ids) -> str:
        return " ".join(self._tokens[i] for i in ids)


def phone_vocab() -> PhonemeVocab:
    """61-phone toneless vocab (size 64 with reserved)."""
    return PhonemeVocab(load_lexicon().phone_set)


def shengdiao_vocab() -> PhonemeVocab:
    """247-phone tone-marked vocab (size 250 with reserved)."""
    return PhonemeVocab(load_lexicon().phone_shengdiao_set)


class PhonemeSeqEncoder:
    """Per-character phoneme-id sequence encoder (one id per input character).

    Used by the lyric-generation side to phonemize free text; each syllable's
    ids are repeated so the output aligns 1:1 with input characters.
    Parity with format_phoneme_seq.py:24-49.
    """

    PUNCT = {",": "SP", ".": "AP", "《": "LP", "》": "RP", "#": "SHARP",
             "？": "QS", "！": "COLON"}

    def __init__(self):
        head = [" ", "SHARP", "AP", "SP", "LP", "RP", "QS", "COLON"]
        # The full 247-token tone-marked list, in its reference order, follows
        # the 8 control symbols in the id space used by this encoder.
        tail = [t for t in load_lexicon().phone_shengdiao_set]
        # Reference hard-codes its own ordering; ours: controls then lexicon
        # order. The mapping is internal to this encoder (never crosses a
        # checkpoint boundary), so ordering only needs to be stable.
        self.tokens = head + [t for t in tail if t not in head]
        self._ids = {t: i for i, t in enumerate(self.tokens)}

    def encode(self, text: str) -> list[int]:
        text = text.replace("ve", "ue")
        n_chars = len(text)
        for k, v in self.PUNCT.items():
            text = text.replace(k, v)
        ids: list[int] = []
        for tok in text.split(" "):
            if tok in self.PUNCT.values():
                ids.append(self._ids[tok])
            elif tok in self._ids:
                ids.extend([self._ids[tok]] * len(tok))
            else:
                parts = split_syllable(tok)
                for p in parts:
                    ids.extend([self._ids[p]] * len(p))
            ids.append(0)
        ids = ids[:-1]
        assert n_chars == len(ids), f"len(text)={n_chars}, len(ids)={len(ids)}"
        return ids
