"""Request-mode heuristics for the pipeline (v1) controller.

Twin of music_generation_tpu/serve/modes.py (host code). Parity:
controllers_music_generation/syn_music.py:14-106,123-181 — strict
precedence keyword/theme > legacy 4-line template > short topic-like text
> raw lyrics, plus the legacy-template theme extraction.
"""

from __future__ import annotations

import re
from typing import Optional

LEGACY_PHRASES = ["在夜色里慢慢发光", "沿着河岸把心事流淌",
                  "风把故事吹成了月光", "唱进你的心房"]

_TEMPLATE_SUFFIXES = [
    "在夜色里慢慢发光", "在夜色里悄悄发光", "在黑夜里慢慢发光", "在夜色里缓缓发光",
]


def looks_like_topic(s: str) -> bool:
    if not s or "\n" in s:
        return False
    if any(p in s for p in "。！？!?，、；"):
        return False
    return len(s) <= 16


def detect_legacy_template(text: str) -> Optional[str]:
    """Theme if >=2 legacy phrases are present, else None."""
    if not text:
        return None
    if sum(1 for key in LEGACY_PHRASES if key in text) < 2:
        return None
    m = re.search(r"我把([^\n，。！？!?、；]{1,20})唱进你的心房", text)
    if m and m.group(1).strip():
        return m.group(1).strip()
    m = re.search(r"([^\n，。！？!?、；]{1,20})在夜色里慢慢发光", text)
    if m and m.group(1).strip():
        return m.group(1).strip()
    return None


def extract_theme_from_template(raw: str) -> Optional[str]:
    """Exact 4-line template -> theme."""
    lines = [l.strip() for l in re.split(r"[\r\n]+", raw or "") if l.strip()]
    if len(lines) != 4:
        return None
    theme = None
    for suf in _TEMPLATE_SUFFIXES:
        if lines[0].endswith(suf) and len(lines[0]) > len(suf):
            theme = lines[0][: -len(suf)].strip("，。！？、；:：  ")
            break
    if not theme:
        m = re.search(r"我把(.+?)唱进你的心房", lines[-1])
        if m:
            theme = m.group(1).strip("，。！？、；:：  ")
    return theme if theme and 0 < len(theme) <= 16 else None


def normalize_to_lines(s: str) -> str:
    return "\n".join(seg.strip() for seg in re.split(r"[。\n]+", s)
                     if seg.strip())


def decide_mode(data: dict) -> tuple[Optional[str], dict]:
    """(mode, payload) for the pipeline backend; mode=None -> invalid input."""
    txt = str(data.get("text", "") or "").strip()
    kw = str(data.get("keyword", data.get("theme", "")) or "").strip()
    raw = str(data.get("raw_lyrics", "") or "").strip()
    payload = {
        "audio_length": int(data.get("audio_length", 95) or 95),
        "ref_prompt": str(data.get("ref_prompt",
                                   "hopeful,ballad,pop,emotion") or "").strip(),
    }
    style = str(data.get("style", "") or "").strip()
    if style:
        payload["style"] = style

    theme_from_template = extract_theme_from_template(raw) if raw else None
    if theme_from_template:
        kw, raw = theme_from_template, ""

    if kw:
        payload["keyword"] = payload["theme"] = kw
        return "theme_from_keyword", payload
    theme_legacy = detect_legacy_template(raw or txt)
    if theme_legacy:
        payload["keyword"] = payload["theme"] = theme_legacy
        return "theme_from_legacy_template", payload
    if txt and looks_like_topic(txt):
        payload["keyword"] = payload["theme"] = txt
        return "theme_from_text", payload
    if raw:
        payload["raw_lyrics"] = normalize_to_lines(raw)
        return "raw_lyrics", payload
    if txt:
        payload["raw_lyrics"] = normalize_to_lines(txt)
        return "raw_from_text", payload
    return None, payload
