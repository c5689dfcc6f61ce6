"""LRC generation + normalization (the lyric2lrc subsystem).

Twin of music_generation_tpu/pipeline/lrc.py (host code: the same strings
for the same input). Parity: lyric2lrc/music_pipeline/py/lyrics2lrc.py
(heuristic per-line durations: clamp(min, base + per_char*N + punc_bonus,
max), strictly increasing centisecond tags) and
py/lrc_validate_normalize.py (strict [mm:ss.cc] form, canonical headers,
monotonic nudging).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

CN_PUNCT = "，。！？、；：“”‘’（）《》—…·"
ASCII_PUNCT = ",.!?;:'\"()[]{}-–—…"
ALL_PUNCT = set(CN_PUNCT + ASCII_PUNCT)

TIME_RE = re.compile(
    r"\[(?P<mm>\d{1,3}):(?P<ss>\d{2})(?:[\.:,](?P<frac>\d{1,3}))?\]")
HEADER_RE = re.compile(r"^\[(ti|ar|al|by|offset):.*\]$", re.IGNORECASE)


@dataclass(frozen=True)
class LrcParams:
    base: float = 0.8
    per_char: float = 0.22
    min_dur: float = 1.6
    max_dur: float = 6.0
    gap: float = 0.25


def count_core_chars(s: str) -> int:
    return sum(1 for ch in s if not ch.isspace() and ch not in ALL_PUNCT)


def punc_bonus(s: str) -> float:
    s = s.strip()
    if not s:
        return 0.0
    last = s[-1]
    if last in "，、,;；：":
        return 0.25
    if last in "。！？!?…":
        return 0.40
    return 0.0


def seconds_to_tag(t: float) -> str:
    total_cs = int(round(max(0.0, t) * 100.0))
    mm, cs_rem = divmod(total_cs, 6000)
    ss, cs = divmod(cs_rem, 100)
    return f"[{mm:02d}:{ss:02d}.{cs:02d}]"


def lyrics_to_lrc(lines: list[str], params: LrcParams = LrcParams(),
                  header: dict | None = None) -> str:
    """Plain lyric lines -> strict LRC text with heuristic timestamps."""
    lines = [ln for ln in lines if ln.strip()]
    durations = [
        min(params.max_dur,
            max(params.min_dur,
                params.base + params.per_char * count_core_chars(ln)
                + punc_bonus(ln)))
        for ln in lines
    ]
    starts, t = [], 0.0
    for i, d in enumerate(durations):
        if i > 0:
            prev_cs = int(round(starts[-1] * 100.0))
            cur_cs = int(round(t * 100.0))
            if cur_cs <= prev_cs:
                t = (prev_cs + 1) / 100.0
        starts.append(t)
        t += d + params.gap

    out = []
    if header:
        for k in ("ti", "ar", "by", "offset"):
            if k in header:
                out.append(f"[{k}:{header[k]}]")
    for st, ln in zip(starts, lines):
        out.append(f"{seconds_to_tag(st)} {ln}")
    return "\n".join(out) + "\n"


def _tag_to_seconds(mm: str, ss: str, frac: str | None) -> float:
    f = frac or "0"
    if len(f) > 2:
        v = round(int(f) / (10 ** (len(f) - 2)))
    else:
        v = int(f.ljust(2, "0"))
    return int(mm) * 60 + int(ss) + v / 100.0


def normalize_lrc(text: str) -> str:
    """Canonicalize any LRC-ish text: one tag per line, [mm:ss.cc], sorted,
    strictly increasing by >= 0.01 s, canonical header order."""
    headers, entries = [], []
    for raw_line in text.splitlines():
        line = raw_line.rstrip("\r\n")
        if not line.strip():
            continue
        if HEADER_RE.match(line):
            headers.append(line)
            continue
        times = TIME_RE.findall(line)
        lyric = TIME_RE.sub("", line).strip()
        for mm, ss, frac in times:
            entries.append((_tag_to_seconds(mm, ss, frac), lyric))

    entries.sort(key=lambda x: x[0])
    fixed, prev_cs = [], -1
    for ts, lyric in entries:
        cs = int(round(ts * 100.0))
        if cs <= prev_cs:
            cs = prev_cs + 1
        prev_cs = cs
        fixed.append((cs / 100.0, lyric))

    out = []
    hdr_map = {h[1:h.find(":")].lower(): h for h in headers}
    for k in ("ti", "ar", "al", "by", "offset"):
        if k in hdr_map:
            out.append(hdr_map[k])
    for ts, lyric in fixed:
        out.append(f"{seconds_to_tag(ts)} {lyric}")
    return "\n".join(out) + ("\n" if out else "")


def parse_lrc(text: str) -> list[tuple[float, str]]:
    """Strict-LRC text -> [(seconds, lyric)]."""
    out = []
    for line in text.splitlines():
        m = TIME_RE.match(line.strip())
        if m:
            out.append((_tag_to_seconds(m["mm"], m["ss"], m["frac"]),
                        TIME_RE.sub("", line).strip()))
    return out
