"""Grapheme-to-phoneme: Chinese characters -> space-separated pinyin+tone string.

Behavior parity with the reference's PhonemeGenerator / TextNormalizer
(text_normalizers/phoneme_generator.py:63-136, text_normalizer.py:32-47):
lowercase -> number verbalization -> symbol canonicalization -> per-character
pinyin lookup with context-window polyphone disambiguation.
"""

from __future__ import annotations

from .lexicon import Lexicon, load_lexicon
from .numbers_cn import normalize_numbers
from .symbols_cn import collapse_sharp, normalize_symbols

_WRAP = 10  # context padding used for phrase matching around a polyphone


def _disambiguate_polyphone(poly: dict, sentence: str, char: str, idx: int) -> str:
    """Pick the pronunciation whose example phrase matches the local context.

    Mirrors phoneme_generator.py:63-108: the 'default' group wins when one of
    its phrases matches in-context; otherwise the first matching non-default
    group; otherwise the default pronunciation.
    """
    groups = poly.get(char)
    if groups is None:
        return char
    idx += _WRAP
    padded = " " * _WRAP + sentence + " " * _WRAP
    default_pronun = ""
    for pronun, phrases in groups.items():
        if phrases and phrases[0] == "default":
            default_pronun = pronun
            for phrase in phrases:
                if len(phrase) > 6 or phrase == "default":
                    continue
                pos = phrase.find(char)
                span = len(phrase)
                if (padded[idx - pos: idx + span - pos] == phrase
                        or padded[idx - pos - 1: idx + span - pos - 1] == phrase):
                    return default_pronun
        else:
            for phrase in phrases:
                if len(phrase) > 6:
                    continue
                pos = phrase.find(char)
                rpos = phrase.rfind(char)
                span = len(phrase)
                if (padded[idx - pos: idx + span - pos] == phrase
                        or padded[idx - rpos: idx + span - rpos] == phrase):
                    return pronun
    return default_pronun


def graphemes_to_phonemes(text: str, lexicon: Lexicon | None = None) -> str:
    """Per-character pinyin conversion; non-Chinese characters pass through."""
    lex = lexicon or load_lexicon()
    text = lex.to_simplified(text)
    out = []
    for i, ch in enumerate(text):
        if ch in lex.polyphone:
            out.append(_disambiguate_polyphone(lex.polyphone, text, ch, i))
        else:
            out.append(lex.monosyllable.get(ch, ch))
    return " ".join(out)


def normalize_text(text: str, word_parse: bool = False,
                   lexicon: Lexicon | None = None) -> str:
    """Full front-end: raw text -> 'sh eng1 d iao4 ...'-style phoneme string."""
    text = text.lower()
    text = normalize_numbers(text)
    text = normalize_symbols(text)
    if word_parse:
        import jieba  # lazy: only the word-parse path needs it
        text = "#".join(jieba.cut(text, cut_all=False))
    text = graphemes_to_phonemes(text, lexicon)
    if word_parse:
        text = collapse_sharp(text)
    return text
