#!/usr/bin/env python3
"""Build the port's G2P lexicon blob from a checkout of the reference.

Twin of tools/build_lexicon.py for music_generation_tpu_torch: the same
five tables, read from the same four reference artifacts, into the single
gzipped JSON blob that music_generation_tpu_torch/frontend/lexicon.py
loads:
  - monosyllable  text_normalizers/data/monosyllable.csv (JSON: char ->
                  pinyin+tone)
  - polyphone     text_normalizers/data/polyphone.csv (JSON: char ->
                  {pinyin: [phrases...]})
  - trad2simp     the two aligned strings TRADITION and SIMPLE of
                  text_normalizers/phoneme_generator.py; the first
                  occurrence of a traditional character wins (str.find)
  - phone_set, phone_shengdiao_set  VISinger/phone_set.json and
                  VISinger/phone_shengdiao_set.json

Usage:
  python tools/torch_build_lexicon.py --ref REFERENCE_CHECKOUT \
      [--out music_generation_tpu_torch/frontend/data/lexicon.json.gz]

--ref defaults to $MUSIC_GEN_REFERENCE_DIR. Writes only --out.
"""

from __future__ import annotations

import argparse
import ast
import gzip
import json
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "music_generation_tpu_torch", "frontend", "data",
                   "lexicon.json.gz")


def _json(ref: str, rel: str):
    with open(os.path.join(ref, rel), encoding="utf-8") as f:
        return json.load(f)


def trad2simp(source: str) -> dict:
    """The TRADITION -> SIMPLE map of phoneme_generator.py's source: the
    two raw-string lines, zipped, first occurrence winning."""
    tables = {}
    for line in source.splitlines():
        key, _, value = line.strip().partition(" = ")
        if key in ("TRADITION", "SIMPLE") and value.startswith('r"'):
            tables[key] = ast.literal_eval(value)
    trad, simp = tables["TRADITION"], tables["SIMPLE"]
    if len(trad) != len(simp):
        raise ValueError(f"TRADITION has {len(trad)} characters, SIMPLE "
                         f"{len(simp)}")
    t2s = {}
    for t, s in zip(trad, simp):
        t2s.setdefault(t, s)
    return t2s


def build_lexicon(ref: str) -> dict:
    with open(os.path.join(ref, "text_normalizers", "phoneme_generator.py"),
              encoding="utf-8") as f:
        t2s = trad2simp(f.read())
    return {
        "monosyllable": _json(ref, "text_normalizers/data/monosyllable.csv"),
        "polyphone": _json(ref, "text_normalizers/data/polyphone.csv"),
        "trad2simp": t2s,
        "phone_set": _json(ref, "VISinger/phone_set.json"),
        "phone_shengdiao_set": _json(ref,
                                     "VISinger/phone_shengdiao_set.json"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ref", default=os.environ.get("MUSIC_GEN_REFERENCE_DIR"),
                   help="reference checkout (default "
                        "$MUSIC_GEN_REFERENCE_DIR)")
    p.add_argument("--out", default=OUT, help="blob to write (default the "
                   "port's frontend/data/lexicon.json.gz)")
    args = p.parse_args(argv)
    if not args.ref:
        p.error("--ref is required when $MUSIC_GEN_REFERENCE_DIR is unset")
    blob = build_lexicon(args.ref)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with gzip.open(args.out, "wt", encoding="utf-8") as f:
        json.dump(blob, f, ensure_ascii=False, separators=(",", ":"))
    print(f"wrote {args.out}: {len(blob['monosyllable'])} mono, "
          f"{len(blob['polyphone'])} poly, {len(blob['trad2simp'])} t2s, "
          f"{len(blob['phone_set'])} phones, "
          f"{len(blob['phone_shengdiao_set'])} tone phones")
    return 0


if __name__ == "__main__":
    sys.exit(main())
