"""Pure-Python BERT WordPiece tokenizer (HF-compatible).

A copy of music_generation_tpu/models/lyrics/wordpiece.py: the port imports
nothing of the JAX package, so it keeps its own pure-Python twin.

The reference GPT-2 lyric model tokenizes with
``BertTokenizerFast(vocab_file='Lyric_generator/checkpoint/vocab.txt', ...)``
plus 8 added special tokens (7 style tokens + <结束>), giving vocab
21128 + 8 = 21136 = the checkpoint's ``config.json.vocab_size``
(Lyric_generator/generator.py:11-19).  This module re-implements that exact
tokenization stdlib-only so retrained/imported checkpoints stay
vocabulary-compatible; golden tests compare ids against
``transformers.BertTokenizerFast`` over the same vocab file
(tests/test_tokenizers.py).

Behavior matched (HF BertTokenizer defaults): text cleaning, CJK char
isolation, lowercasing + accent stripping, punctuation splitting, greedy
longest-match WordPiece with '##' continuations and a 100-char word cap.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"

# Order matters: the reference adds these via add_special_tokens so they get
# ids 21128..21135 in list order (Lyric_generator/generator.py:12-16).
STYLE_TOKENS = (
    "<Folk 民谣>", "<Soundtrack 原声>", "<Ancientry 古风>",
    "<Rap/Hip Hop & Dance 舞曲>", "<Children Music 儿童音乐>", "<Pop 流行>",
    "<Rock 摇滚 & Metal 金属>",
)
EOS = "<结束>"
ADDED_TOKENS = STYLE_TOKENS + (EOS,)

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """HF-BertTokenizer-equivalent encoder/decoder over a vocab.txt."""

    def __init__(self, vocab_file: str,
                 added_tokens: Iterable[str] = ADDED_TOKENS,
                 do_lower_case: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.tokens: List[str] = [ln.rstrip("\n") for ln in f]
        while self.tokens and self.tokens[-1] == "":
            self.tokens.pop()
        self._added = [t for t in added_tokens if t]
        self.tokens += self._added
        self._ids = {t: i for i, t in enumerate(self.tokens)}
        self.do_lower_case = do_lower_case
        self.unk_id = self._ids[UNK]

    # ---- id properties shared with CharTokenizer's interface ----
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
        return self._ids.get(token, self.unk_id)

    # ---- BasicTokenizer ----
    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > 100:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._ids:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        # split on added special tokens first (they bypass normalization)
        segments = [text]
        for sp in self._added:
            nxt: List[str] = []
            for seg in segments:
                if seg in self._added:
                    nxt.append(seg)
                    continue
                parts = seg.split(sp)
                for i, part in enumerate(parts):
                    if i:
                        nxt.append(sp)
                    if part:
                        nxt.append(part)
            segments = nxt
        out: List[str] = []
        for seg in segments:
            if seg in self._added:
                out.append(seg)
            else:
                for w in self._basic_tokenize(seg):
                    out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str,
               add_special_tokens: bool = False) -> List[int]:
        ids = [self._ids.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids, skip_special: bool = False) -> str:
        skip: set = set()
        if skip_special:
            skip = {PAD, UNK, CLS, SEP, MASK, *self._added}
        toks = [self.tokens[i] for i in ids
                if 0 <= i < len(self.tokens) and self.tokens[i] not in skip]
        # HF convert_tokens_to_string is ' '.join(...).replace(' ##', '');
        # every reference call site strips spaces afterwards, so join bare.
        return "".join(t[2:] if t.startswith("##") else t for t in toks)
