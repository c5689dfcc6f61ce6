"""Pure-Python SentencePiece **unigram** encoder/decoder (stdlib only).

A copy of music_generation_tpu/models/lyrics/spm.py: the port imports
nothing of the JAX package, so it keeps its own pure-Python twin.

The reference T5 lyric model tokenizes with
``T5Tokenizer.from_pretrained('Lyric_generator_t5/checkpoint')`` — a
sentencepiece unigram model (``spiece.model``, 32028 pieces; Mengzi-T5) plus
100 ``<extra_id_k>`` sentinels → vocab 32128
(Lyric_generator_t5/generator.py:21-27, checkpoint/config.json).  The
``sentencepiece`` package is absent from this environment by design, so this
module re-implements the full contract from the model proto itself:

  * minimal protobuf wire-format reader for ``ModelProto`` (no protobuf dep);
  * the precompiled ``nmt_nfkc`` charsmap normalizer — a darts-clone
    double-array trie over UTF-8 prefixes mapping to replacement strings —
    with sentencepiece's whitespace rules (remove_extra_whitespaces,
    escape to ``▁``, optional dummy prefix);
  * unigram Viterbi segmentation with sentencepiece's unk penalty (10.0)
    and tie-breaking (longest-piece-first among equal scores).

Golden tests compare ids against an independently constructed HF
``tokenizers`` Unigram pipeline (tests/test_tokenizers.py).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

WS = "▁"  # ▁
_UNK_PENALTY = 10.0

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# --------------------------------------------------------------------------
# Minimal protobuf wire reader (proto2, only what ModelProto needs)
# --------------------------------------------------------------------------

def _iter_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:  # groups (3/4) unused by sentencepiece
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _f32(raw: bytes) -> float:
    return struct.unpack("<f", raw)[0]


class _Piece:
    __slots__ = ("piece", "score", "type")

    def __init__(self, piece: str, score: float, type_: int):
        self.piece, self.score, self.type = piece, score, type_


def _parse_model_proto(blob: bytes):
    pieces: List[_Piece] = []
    trainer: Dict[int, int] = {}
    norm: Dict[str, object] = dict(precompiled_charsmap=b"",
                                   add_dummy_prefix=True,
                                   remove_extra_whitespaces=True,
                                   escape_whitespaces=True)
    for field, wire, val in _iter_fields(blob):
        if field == 1:  # repeated SentencePiece
            piece, score, type_ = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = _f32(v2)
                elif f2 == 3:
                    type_ = v2
            pieces.append(_Piece(piece, score, type_))
        elif field == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 in (3, 40, 41, 42, 43):  # model_type + special ids
                    trainer[f2] = v2
        elif field == 3:  # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2:
                    norm["precompiled_charsmap"] = v2
                elif f2 == 3:
                    norm["add_dummy_prefix"] = bool(v2)
                elif f2 == 4:
                    norm["remove_extra_whitespaces"] = bool(v2)
                elif f2 == 5:
                    norm["escape_whitespaces"] = bool(v2)
    return pieces, trainer, norm


# --------------------------------------------------------------------------
# darts-clone double-array trie (read-only common-prefix search)
# --------------------------------------------------------------------------

class _DoubleArray:
    def __init__(self, units_raw: bytes):
        self._units = struct.unpack(f"<{len(units_raw) // 4}I", units_raw)

    def common_prefix_search(self, key: bytes) -> List[Tuple[int, int]]:
        """All (value, matched_byte_len) for prefixes of ``key`` in the trie."""
        units = self._units
        results: List[Tuple[int, int]] = []
        node_pos = 0
        unit = units[node_pos]
        node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
        for i, c in enumerate(key):
            if c == 0:
                break
            node_pos ^= c
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                break
            node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if (unit >> 8) & 1:  # has_leaf
                results.append((units[node_pos] & 0x7FFFFFFF, i + 1))
        return results


class _PrecompiledCharsmap:
    """sentencepiece normalizer: trie of UTF-8 prefixes → replacement text."""

    def __init__(self, blob: bytes):
        if not blob:
            self._trie = None
            self._normalized = b""
            return
        (trie_size,) = struct.unpack("<I", blob[:4])
        self._trie = _DoubleArray(blob[4:4 + trie_size])
        self._normalized = blob[4 + trie_size:]

    def normalize_prefix(self, data: bytes) -> Tuple[str, int]:
        """Longest trie replacement at the head of ``data``; falls back to
        passing one UTF-8 char through unchanged."""
        if self._trie is not None:
            matches = self._trie.common_prefix_search(data[:64])
            if matches:
                value, length = matches[-1]  # longest
                end = self._normalized.index(b"\0", value)
                return self._normalized[value:end].decode("utf-8"), length
        # consume one codepoint unchanged
        n = 1
        first = data[0]
        if first >= 0xF0:
            n = 4
        elif first >= 0xE0:
            n = 3
        elif first >= 0xC0:
            n = 2
        try:
            return data[:n].decode("utf-8"), n
        except UnicodeDecodeError:
            return "�", 1


class SentencePieceUnigram:
    """Encode/decode exactly like ``sentencepiece`` for a unigram model."""

    def __init__(self, model_file: str):
        with open(model_file, "rb") as f:
            blob = f.read()
        self.pieces, trainer, norm = _parse_model_proto(blob)
        if trainer.get(3, 1) != 1:
            raise ValueError("only unigram (model_type=1) models supported")
        self.unk_id = trainer.get(40, 0)
        self.bos_id = trainer.get(41, -1)
        self.eos_id = trainer.get(42, 1)
        self.pad_id_ = trainer.get(43, -1)
        self._charsmap = _PrecompiledCharsmap(norm["precompiled_charsmap"])
        self._add_dummy_prefix = norm["add_dummy_prefix"]
        self._remove_extra_ws = norm["remove_extra_whitespaces"]
        self._escape_ws = norm["escape_whitespaces"]
        self._ids = {p.piece: i for i, p in enumerate(self.pieces)}
        min_score = min((p.score for p in self.pieces
                         if p.type == NORMAL), default=0.0)
        self._unk_score = min_score - _UNK_PENALTY
        # char-level trie over scorable pieces for the Viterbi lattice
        self._trie: dict = {}
        self._max_piece_len = 1
        for i, p in enumerate(self.pieces):
            if p.type in (NORMAL, USER_DEFINED):
                node = self._trie
                for ch in p.piece:
                    node = node.setdefault(ch, {})
                node[None] = (i, p.score if p.type == NORMAL else 1e6)
                self._max_piece_len = max(self._max_piece_len, len(p.piece))

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ---- normalization -------------------------------------------------
    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        pos = 0
        if self._remove_extra_ws:
            while pos < len(data) and data[pos:pos + 1] == b" ":
                pos += 1
        out: List[str] = []
        prev_space = False
        pending = " " if (self._add_dummy_prefix and pos < len(data)) else ""
        while pending or pos < len(data):
            if pending:
                rep, pending = pending, ""
            else:
                rep, consumed = self._charsmap.normalize_prefix(data[pos:])
                pos += consumed
            for ch in rep:
                if ch == " ":
                    if prev_space and self._remove_extra_ws:
                        continue
                    out.append(WS if self._escape_ws else " ")
                    prev_space = True
                else:
                    out.append(ch)
                    prev_space = False
        if self._remove_extra_ws:
            ws = WS if self._escape_ws else " "
            while out and out[-1] == ws:
                out.pop()
        return "".join(out)

    # ---- unigram Viterbi -----------------------------------------------
    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        ids = self._viterbi(self.normalize(text))
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def encode_pieces(self, text: str) -> List[str]:
        return [self.pieces[i].piece for i in self._viterbi(
            self.normalize(text))]

    def _viterbi(self, s: str) -> List[int]:
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            node = self._trie
            has_single = False
            j = i
            # walk matches longest-first is not possible with a forward trie
            # walk; instead record all and rely on strict-> update with the
            # earlier (longer-predecessor) win at each end position.
            while j < n and (s[j] in node):
                node = node[s[j]]
                j += 1
                leaf = node.get(None)
                if leaf is not None:
                    pid, score = leaf
                    if j - i == 1:
                        has_single = True
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, pid)
            if not has_single:
                cand = best[i] + self._unk_score
                if cand > best[j0 := i + 1]:
                    best[j0] = cand
                    back[j0] = (i, self.unk_id)
        # backtrack (merge adjacent unks like sentencepiece does NOT — spm
        # emits one unk per unmatched char; HF tokenizers fuses them; we
        # follow sentencepiece)
        out: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            out.append(pid)
            j = i
        out.reverse()
        return out

    # ---- decode ----------------------------------------------------------
    def id_to_piece(self, i: int) -> str:
        return self.pieces[i].piece

    def piece_to_id(self, piece: str) -> int:
        return self._ids.get(piece, self.unk_id)

    def decode(self, ids, skip_special: bool = True) -> str:
        toks = []
        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            if skip_special and p.type in (CONTROL, UNKNOWN):
                continue
            toks.append(p.piece)
        return "".join(toks).replace(WS, " ").strip()


class T5SentencePieceTokenizer:
    """HF-slow-``T5Tokenizer`` contract over a SentencePiece unigram model:
    sp ids map 1:1, 100 ``<extra_id_k>`` sentinels occupy the top of the
    vocab reversed (extra_id_0 = vocab_size-1), ``encode`` appends ``</s>``.

    Exposes the same surface as ``CharTokenizer`` so the lyric API can use
    either (models/lyrics/api.py)."""

    def __init__(self, model_file: str, extra_ids: int = 100):
        self.sp = SentencePieceUnigram(model_file)
        self.extra_ids = extra_ids

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size + self.extra_ids

    @property
    def pad_id(self) -> int:
        return max(self.sp.pad_id_, 0)

    @property
    def eos_id(self) -> int:
        return self.sp.eos_id

    @property
    def unk_id(self) -> int:
        return self.sp.unk_id

    def token_id(self, token: str) -> int:
        if token.startswith("<extra_id_") and token.endswith(">"):
            return self.vocab_size - 1 - int(token[10:-1])
        return self.sp.piece_to_id(token)

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        return self.sp.encode(text, add_eos=add_eos)

    def decode(self, ids, skip_special: bool = True) -> str:
        return self.sp.decode([i for i in ids if i < self.sp.vocab_size],
                              skip_special=skip_special)
