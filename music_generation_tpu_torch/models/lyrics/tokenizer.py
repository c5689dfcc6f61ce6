"""Character-level FALLBACK tokenizer for the Chinese lyric LMs.

A copy of music_generation_tpu/models/lyrics/tokenizer.py: the port imports
nothing of the JAX package, so it keeps its own pure-Python twin.

The reference-compatible tokenizers live in wordpiece.py (BERT WordPiece,
GPT-2) and spm.py (sentencepiece unigram, T5) and are preferred whenever the
vocab artifacts are available (models/lyrics/api.py:default_tokenizer). This
char-level tokenizer remains for (a) environments without the artifacts and
(b) tiny test/serving builds where a 21k/32k-row embedding is wasteful:
Chinese lyric text is effectively character-level, and the vocabulary is
fully derivable from the in-tree G2P lexicon charset + ASCII + control
tokens, so the stack stays self-contained.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ...frontend import load_lexicon

PAD, CLS, SEP, UNK, EOS = "[PAD]", "[CLS]", "[SEP]", "[UNK]", "<结束>"
STYLE_TOKENS = (
    "<Folk 民谣>", "<Soundtrack 原声>", "<Ancientry 古风>",
    "<Rap/Hip Hop & Dance 舞曲>", "<Children Music 儿童音乐>", "<Pop 流行>",
    "<Rock 摇滚 & Metal 金属>",
)
_ASCII = [chr(c) for c in range(32, 127)]
_PUNCT = list("，。！？、；：“”‘’（）《》…—")


@dataclass
class CharTokenizer:
    extra_tokens: tuple = ()
    _ids: dict = field(init=False, repr=False)

    def __post_init__(self):
        chars = sorted(set(load_lexicon().monosyllable.keys()))
        specials = [PAD, CLS, SEP, UNK, EOS, *STYLE_TOKENS, *self.extra_tokens]
        self.tokens = specials + _ASCII + _PUNCT + chars
        self._ids = {t: i for i, t in enumerate(self.tokens)}

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    @property
    def pad_id(self) -> int:
        return self._ids[PAD]

    @property
    def cls_id(self) -> int:
        return self._ids[CLS]

    @property
    def sep_id(self) -> int:
        return self._ids[SEP]

    @property
    def eos_id(self) -> int:
        return self._ids[EOS]

    def token_id(self, token: str) -> int:
        return self._ids.get(token, self._ids[UNK])

    def encode(self, text: str, add_eos: bool = False) -> list[int]:
        ids = [self._ids.get(ch, self._ids[UNK]) for ch in text]
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids, skip_special: bool = False) -> str:
        toks = [self.tokens[i] for i in ids if 0 <= i < len(self.tokens)]
        if skip_special:
            skip = {PAD, CLS, SEP, UNK, EOS, *STYLE_TOKENS, *self.extra_tokens}
            toks = [t for t in toks if t not in skip]
        return "".join(toks)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.tokens, f, ensure_ascii=False)
