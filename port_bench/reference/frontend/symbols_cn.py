"""Punctuation / symbol canonicalization for the text front-end.

Behavior parity with the reference's SymbolNormalizer
(text_normalizers/symbol_normalizer.py:16-133): CN->ASCII punctuation, unit
expansion, collapse runs of pause symbols, force a '.' sentence tail.
Intentional deviation: the reference returns None for an all-punctuation input
(normalize_text_tail falls off the loop); we return ".".
"""

from __future__ import annotations

import re

_CN_TO_ASCII = {
    "，": ",", "。": ".", "？": "?", "！": "!", "·": "-", "：": ":", "；": ";",
    "“": "'", "”": "'", "{": "{", "}": "}", "【": "[", "】": "]", "《": "<",
    "》": ">", "（": "(", "）": ")", "＂": "'", "∙": "", "、": ",", "‘": "'",
    "’": "'", "……": ",", "•": "-", "「": "'", "」": "'", "\n": "", " ": ",",
    "—": "-", "．": ".",
    "℃": "摄氏度", "℉": "华氏度", "+": "加",
    "km/h": "千米每小时", "m/s": "米每秒", "119火警": "幺幺九火警",
    "AAAAA风景区": "五A风景区", "AAAA风景区": "四A风景区", "AAA风景区": "三A风景区",
    "AAAAA级": "五A级", "AAAA级": "四A级", "AAA级": "三A级",
}

_EN_CANON = {
    "-": ";", "_": ",", "{": ";", "}": ";", "(": ";", ")": ";", "[": ";",
    "]": ";", "<": ";", ">": ";", "'": ";", "\"": ";", ";": ",", ":": ",",
    ",": ",", ".": ".", "?": ".", "!": ".",
}

PAUSE_SYMBOLS = set("-_{}[]()<>'\";:,.?! ")

_SHARP_SEMI = re.compile(r"# ; #")
_SHARP_COMMA = re.compile(r"# , #")
_SHARP_DOT = re.compile(r"# \. #")
_SHARP_RUN = re.compile(r"(# )+")


def normalize_symbols(text: str) -> str:
    for k, v in _CN_TO_ASCII.items():
        text = text.replace(k, v)
    for k, v in _EN_CANON.items():
        text = text.replace(k, v)
    # Collapse runs of pause symbols, keeping the first.
    out, prev = [], ""
    for ch in text:
        if ch in PAUSE_SYMBOLS and prev in PAUSE_SYMBOLS:
            continue
        out.append(ch)
        prev = ch
    text = "".join(out)
    # Replace any trailing pause run with a single '.'.
    if not text:
        return text
    i = len(text)
    while i > 0 and text[i - 1] in PAUSE_SYMBOLS:
        i -= 1
    return text[:i] + "."


def collapse_sharp(text: str) -> str:
    """Squeeze the '#' word-boundary markers emitted by word segmentation."""
    text = _SHARP_SEMI.sub("# ;", text)
    text = _SHARP_COMMA.sub("# ,", text)
    text = _SHARP_DOT.sub("# .", text)
    return _SHARP_RUN.sub("# ", text)
