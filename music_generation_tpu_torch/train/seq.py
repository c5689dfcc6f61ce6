"""Training CLI for the sequence models (melody and lyric families).

Twin of music_generation_tpu/train/seq.py: no trained melody or lyric
weights ship (.MISSING_LARGE_BLOBS), so training is how the framework gets
usable ones. This driver trains any family to a falling loss, with
``torch.save`` checkpoints and resume:

  python -m music_generation_tpu_torch.train.seq --family melody_note \
      [--data transcriptions.txt] [--steps N] [--ckpt-dir D] \
      [--resume D/melody_note/step_K.pt] [--tiny] [--device cpu]

Families:
  melody_note   lyric chars -> note tokens (label-smoothed CE;
                transformer_melody/model.py training surface)
  melody_note_prev  same model through the previous-sentence memory, in
                the "concat" mode (MelodyConfig.prev_mode)
  seq2seq       the melody_v2 RNN family: lyric2note + lyric2duration +
                note2duration trained jointly (Melody/seq2seq)
  telemelody    the v1 twin transformers: lyric2rhythm + trend2melody
                trained jointly (Melody/telemelody)
  duration_mse  log-duration regression (MSE/mse_inference.py head)
  duration_sdp  stochastic-duration-predictor flow NLL
                (transformer_melody/Lyric2Duration)
  gpt2          causal LM CE (Lyric_generator)
  t5            seq2seq CE keyword->lyrics (Lyric_generator_t5)

Data: --data takes the SVS transcription format
(name|text|phones|notes|note_durs|phone_durs) for the melody families and a
plain one-lyric-per-line file for the LM families; without it a
deterministic synthetic set (train/toydata.py scores for melody, the
lyric grammar below for LMs). The data code below is the JAX package's,
numpy only. Runs on ``cuda`` unless given ``--device``; dropout masks come
from a torch.Generator on the device seeded with ``--seed`` + 1.
``tools/torch_export_trained_melody.py`` turns a melody_note and a
duration_mse checkpoint into the files ``serve.app --checkpoint-dir``
serves.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib

import numpy as np


def _stable_hash(s: str) -> int:
    """Process-stable hash for synthetic target mappings. Python's built-in
    hash() is salted per process (PYTHONHASHSEED), which would remap every
    toy target on restart and break --resume / cross-process eval."""
    return zlib.crc32(s.encode("utf-8"))


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def _syllable_group_starts(phones: list[str]) -> list[int]:
    """Indices where each syllable's phone group begins. A syllable is
    either [initial, final+tone] or a single token: a zero-initial final
    ('a1' — no separate initial) or a special (SP/AP/rest). Grouping by the
    trailing tone digit is robust to 1-phone syllables, which a naive [::2]
    stride silently misaligns."""
    starts, in_group = [], False
    for i, p in enumerate(phones):
        if not in_group:
            starts.append(i)
        ends_group = p[-1:].isdigit() or p in ("SP", "AP", "rest")
        in_group = not ends_group
    return starts


def _melody_pairs_from_transcriptions(path: str):
    """[(text, note_names, note_durs_seconds)] from the SVS format."""
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            _name, text, phones, notes, ndurs = parts[:5]
            # one note per syllable; phones duplicate across a syllable's
            # initial/final, so take each group's first note/duration
            starts = _syllable_group_starts(phones.split(" "))
            note_all = notes.split(" ")
            dur_all = [float(x) for x in ndurs.split(" ")]
            note_list = [note_all[i] for i in starts]
            dur_list = [dur_all[i] for i in starts]
            pairs.append((text, note_list, dur_list))
    return pairs


def _toy_melody_pairs(n: int = 64, syllables: int = 6, seed: int = 0):
    from .toydata import _SYL_TEXT, _TOY_NOTES, _TOY_SYLLABLES
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        syls = [str(rng.choice(_TOY_SYLLABLES)) for _ in range(syllables)]
        text = "".join(_SYL_TEXT[s] for s in syls)
        # deterministic char->note mapping => learnable
        notes = [_TOY_NOTES[_stable_hash(ch) % len(_TOY_NOTES)]
                 for ch in text]
        durs = [0.25 + 0.05 * (_stable_hash(ch) % 5) for ch in text]
        pairs.append((text, notes, durs))
    return pairs


def _toy_melody_pairs_prev(n: int = 64, syllables: int = 6, seed: int = 0):
    """Two-sentence songs where the SECOND sentence's notes depend on the
    previous sentence's last note — decodable only through the
    previous-sentence memory (api._beam_impl use_prev): sentence 2 is the
    pentatonic scale CONTINUED from where sentence 1 ended
    (notes2[j] = scale[(start + 1 + j) % 5]). The start note is drawn
    uniformly, so a model that ignores prev is capped at exactly 1/5 per
    note position; reading prev makes every note deterministic. (An earlier
    design derived notes2 from hash(char)+shift — modular composition the
    tiny probe model couldn't fit, which masked the channel's effect.)"""
    from .toydata import _SYL_TEXT, _TOY_NOTES, _TOY_SYLLABLES
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        syls1 = [str(rng.choice(_TOY_SYLLABLES)) for _ in range(syllables)]
        syls2 = [str(rng.choice(_TOY_SYLLABLES)) for _ in range(syllables)]
        text1 = "".join(_SYL_TEXT[s] for s in syls1)
        text2 = "".join(_SYL_TEXT[s] for s in syls2)
        notes1 = [_TOY_NOTES[_stable_hash(ch) % len(_TOY_NOTES)]
                  for ch in text1]
        start = int(rng.randint(len(_TOY_NOTES)))
        notes1[-1] = _TOY_NOTES[start]
        notes2 = [_TOY_NOTES[(start + 1 + j) % len(_TOY_NOTES)]
                  for j in range(len(text2))]
        durs = [0.3] * syllables
        pairs.append((text2, notes2, durs, notes1))
    return pairs


# ---------------------------------------------------------------------------
# Toy lyric grammar (CFG): PHRASE -> [ADJ] SUBJ (VT OBJ | VI).
# The reference shipped corpus-trained LMs (Lyric_generator/checkpoint,
# 21136-vocab GPT-2 + Mengzi-T5); no corpus survives in the snapshot, so the
# toy corpus must itself be grammatical for the trained LMs to emit lines a
# reader parses as sentences (round-4 keyword->song output was song-SHAPED
# but char soup). Every lexicon entry is a >=2-char word; phrases compose
# subject-verb-object song clichés, so lyric_grammar_check can verify that
# generated text segments back into the grammar.
_LYRIC_ADJS = ("温柔的", "遥远的", "年少的", "自由的")
_LYRIC_SUBJECTS = ("月亮", "星星", "少年", "夏天", "清风", "大海",
                   "时光", "梦想", "远方", "花朵")
_LYRIC_VT = ("照亮", "吹过", "带走", "拥抱", "唱起", "飞过", "想起", "点亮")
_LYRIC_VI = ("歌唱", "流浪", "闪耀", "绽放")
_LYRIC_OBJECTS = ("我的心", "你的眼", "那片海", "这条路", "旧时光",
                  "小村庄", "金麦浪", "夜空中")
#: every word the grammar can emit (all >=2 chars), longest-first for the
#: greedy segmenter in lyric_grammar_check
LYRIC_WORDS = tuple(sorted(
    _LYRIC_ADJS + _LYRIC_SUBJECTS + _LYRIC_VT + _LYRIC_VI + _LYRIC_OBJECTS,
    key=len, reverse=True))
_LYRIC_PUNCT = "，。！？、,.!? "


def _toy_lyric_phrase(rng) -> str:
    parts = []
    if rng.rand() < 0.3:
        parts.append(_LYRIC_ADJS[int(rng.randint(len(_LYRIC_ADJS)))])
    parts.append(_LYRIC_SUBJECTS[int(rng.randint(len(_LYRIC_SUBJECTS)))])
    if rng.rand() < 0.75:
        parts.append(_LYRIC_VT[int(rng.randint(len(_LYRIC_VT)))])
        parts.append(_LYRIC_OBJECTS[int(rng.randint(len(_LYRIC_OBJECTS)))])
    else:
        parts.append(_LYRIC_VI[int(rng.randint(len(_LYRIC_VI)))])
    return "".join(parts)


def _toy_lyric_lines(n: int = 128, seed: int = 0):
    """Song-shaped toy lyrics from the CFG above: every example is 3-5
    comma-separated grammatical phrases closed with '。', so LMs trained on
    it learn BOTH sentence boundaries/termination (the downstream pipeline
    splits on that punctuation — pipeline/synthesis.py split_sentences) and
    word-level structure a reader parses as sentences."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        k = 3 + int(rng.randint(3))
        lines.append("，".join(_toy_lyric_phrase(rng)
                               for _ in range(k)) + "。")
    return lines


def lyric_grammar_check(text: str) -> dict:
    """Structure check for generated lyrics against the toy CFG.

    Reports per-phrase greedy-segmentation results over LYRIC_WORDS
    (all >=2-char lexicon words):
      - no_isolated_punct: no leading punctuation and no empty segment
        between punctuation marks ('，，' / '唱，。' style degeneracy)
      - phrases_with_word_frac: phrases containing >=1 lexicon word
      - parsed_frac: phrases that segment COMPLETELY into lexicon words
      - passed: no_isolated_punct AND every phrase has a word AND a
        majority (>=0.5) of phrases parse fully
    """
    phrases, cur = [], []
    no_isolated = bool(text) and text[0] not in _LYRIC_PUNCT
    prev_punct = False
    for ch in text.strip():
        if ch in _LYRIC_PUNCT:
            if prev_punct:
                no_isolated = False
            if cur:
                phrases.append("".join(cur))
                cur = []
            prev_punct = True
        else:
            cur.append(ch)
            prev_punct = False
    if cur:  # unterminated trailing phrase still gets judged
        phrases.append("".join(cur))

    def segment(phrase):
        i, words, clean = 0, [], True
        while i < len(phrase):
            for w in LYRIC_WORDS:
                if phrase.startswith(w, i):
                    words.append(w)
                    i += len(w)
                    break
            else:
                clean = False
                i += 1
        return words, clean

    segs = [segment(ph) for ph in phrases]
    n = len(phrases)
    with_word = sum(1 for w, _ in segs if w)
    full = sum(1 for w, c in segs if w and c)
    return {
        "n_phrases": n,
        "no_isolated_punct": no_isolated,
        "phrases_with_word_frac": round(with_word / n, 4) if n else 0.0,
        "parsed_frac": round(full / n, 4) if n else 0.0,
        "passed": bool(n and no_isolated and with_word == n
                       and full / n >= 0.5),
    }


class _MelodyBatcher:
    """Fixed-shape (src, tgt_in, tgt_out, durations) batches."""

    def __init__(self, pairs, lyric_dict, note_dict, t_len: int = 32,
                 seed: int = 0):
        self.pairs = pairs
        self.ld, self.nd = lyric_dict, note_dict
        self.t = t_len
        self.rng = np.random.RandomState(seed)

    def batch(self, bs: int):
        t = self.t
        src = np.zeros((bs, t), np.int32)
        tgt_in = np.zeros((bs, t + 1), np.int32)
        tgt_out = np.zeros((bs, t + 1), np.int32)
        dur = np.zeros((bs, t), np.float32)
        picks = self.rng.choice(len(self.pairs), bs)
        has_prev = len(self.pairs[0]) == 4
        prev = np.zeros((bs, t), np.int32) if has_prev else None
        from ..frontend import note_to_midi
        for i, p in enumerate(picks):
            pair = self.pairs[p]
            text, notes, durs = pair[:3]
            if has_prev:
                # serving layout for the conditioning sentence
                # (api.generate: [BOS] + note ids + [EOS], trailing rest
                # dropped upstream)
                pids = ([self.nd.bos_id]
                        + self.nd.encode(
                            [str(note_to_midi(x)) if x != "rest" else x
                             for x in pair[3]])
                        + [self.nd.eos_id])[:t]
                prev[i, : len(pids)] = pids
            # SERVING convention (api._encode_src / the reference's
            # transformer_melody rpad): src = [BOS] chars [EOS]; durations
            # align with the char positions 1..n (format_durations strips
            # the BOS/EOS slots). Training with bare chars would shift every
            # inference-time input one position off what the model saw.
            ids = ([self.ld.bos_id] + self.ld.encode(list(text))
                   + [self.ld.eos_id])[:t]
            nids = self.nd.encode(
                [str(note_to_midi(n)) if n != "rest" else n
                 for n in notes])[:t]
            src[i, : len(ids)] = ids
            tgt_in[i, 0] = self.nd.bos_id
            tgt_in[i, 1: len(nids) + 1] = nids
            tgt_out[i, : len(nids)] = nids
            tgt_out[i, len(nids)] = self.nd.eos_id
            cs = np.round(np.asarray(durs) * 100.0)[: t - 2]
            dur[i, 1: 1 + len(cs)] = cs
        out = {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_out,
               "durations_cs": dur}
        if has_prev:
            out["prev"] = prev
        return out


class _Seq2SeqBatcher:
    """Batches for the three-model melody_v2 family. Vocabularies are the
    SERVING ones (seq2seq_api.default_langs) so trained checkpoints drop
    into Seq2SeqMelodyGenerator; sequences start with _START_ and end with
    _EOS_ exactly like beam_decode expects."""

    def __init__(self, pairs, langs, t_len: int = 16, seed: int = 0):
        from ..models.melody.seq2seq import EOS_ID, START_ID
        self.pairs = pairs
        self.lyric_lang, self.note_lang, self.dur_lang = langs
        self.t = t_len
        self.start, self.eos = START_ID, EOS_ID
        self.rng = np.random.RandomState(seed)
        # duration grid derived from the vocabulary itself (snapping against
        # hardcoded constants would silently map everything to _UNK_ if the
        # lang ever changed)
        self._dur_values = np.asarray(
            sorted(float(e) for e in self.dur_lang.item2index
                   if e.replace(".", "").isdigit()))
        self._dur_tokens = [f"{v:.4f}" for v in self._dur_values]

    def _snap_duration(self, d: float) -> str:
        i = int(np.argmin(np.abs(self._dur_values - float(d))))
        return self._dur_tokens[i]

    def _tgt(self, ids, t):
        tin = np.zeros((t + 1,), np.int32)
        tout = np.zeros((t + 1,), np.int32)
        ids = ids[:t]
        tin[0] = self.start
        tin[1: len(ids) + 1] = ids
        tout[: len(ids)] = ids
        tout[len(ids)] = self.eos
        return tin, tout

    def batch(self, bs: int):
        t = self.t
        out = {"lyric_src": np.zeros((bs, t), np.int32),
               "note_src": np.zeros((bs, t), np.int32),
               "note_in": np.zeros((bs, t + 1), np.int32),
               "note_out": np.zeros((bs, t + 1), np.int32),
               "dur_in": np.zeros((bs, t + 1), np.int32),
               "dur_out": np.zeros((bs, t + 1), np.int32)}
        picks = self.rng.choice(len(self.pairs), bs)
        for i, p in enumerate(picks):
            text, notes, durs = self.pairs[p][:3]
            # serving appends EOS to every encoder source
            # (seq2seq_api._decode: ids[:n_pad-1] + [EOS_ID]) — match it so
            # the EOS embedding/attention position is trained
            # truncate BEFORE appending EOS (serving keeps the EOS even on
            # max-length inputs: seq2seq_api ids[:n_pad-1] + [EOS])
            lids = self.lyric_lang.encode(list(text))[: t - 1] + [self.eos]
            nids_src = self.note_lang.encode(notes)[: t - 1] + [self.eos]
            nids = self.note_lang.encode(notes)[:t]
            dids = self.dur_lang.encode(
                [self._snap_duration(d) for d in durs])[:t]
            out["lyric_src"][i, : len(lids)] = lids
            out["note_src"][i, : len(nids_src)] = nids_src
            out["note_in"][i], out["note_out"][i] = self._tgt(nids, t)
            out["dur_in"][i], out["dur_out"][i] = self._tgt(dids, t)
        return out


def _telemelody_pairs_from_transcriptions(path: str):
    """Real-data (chars, rhythm, trend, notes) token streams for TeleMelody
    from SVS transcriptions: the note onsets/durations are quantized onto
    the serving REMI grid (16 positions per bar, Pos unit = 0.125 s), beat
    classes come from the onset position, and the trend stream follows the
    generate_melody layout (MAJ + per-note Chord/NOT|AUT/BEAT with the fixed
    chord progression, Melody/telemelody/model.py:189-217)."""
    from ..models.melody.telemelody import DEFAULT_CHORDS

    chords_list = DEFAULT_CHORDS.split()
    unit = 0.125  # seconds per Pos step; 16 steps = one 2 s bar
    pairs = []
    for text, notes, durs in _melody_pairs_from_transcriptions(path):
        from ..frontend import note_to_midi
        chars = list(text)[: len(notes)]
        onset = 0.0
        rhythm, trend, note_toks = [], ["MAJ"], []
        for k, (note, dur) in enumerate(zip(notes, durs)):
            units = int(round(onset / unit))
            bar, pos = min(units // 16, 63), units % 16
            beat = pos // 4
            dur_units = min(max(int(round(dur / unit)), 1), 16)
            chord = chords_list[bar % len(chords_list)]
            rhythm.append(str(beat))
            trend += [f"Chord_{chord}",
                      "AUT" if k == len(chars) - 1 else "NOT",
                      f"BEAT_{beat}"]
            midi = 60 if note == "rest" else int(note_to_midi(note))
            note_toks += [f"Bar_{bar}", f"Pos_{pos}",
                          f"Pitch_{min(max(midi, 40), 95)}",
                          f"Dur_{dur_units}"]
            onset += float(dur)
        pairs.append((chars, rhythm, trend, note_toks))
    return pairs


class _TeleMelodyBatcher:
    """Token-stream batches for TeleMelody's twin transformers.

    Layouts mirror the sampler (telemelody.py _sample + generate_melody):
    encoder input is `ids + [EOS]`, decoding starts at BOS and ends at EOS,
    and trend streams carry the leading MAJ token plus NOT/HALF/AUT section
    enders the serving path emits. Without ``pairs``, targets are synthetic
    deterministic (stable-hash) functions of the inputs; with ``pairs``
    (from _telemelody_pairs_from_transcriptions) both models train on real
    rhythm/trend/note streams derived from transcriptions.
    """

    def __init__(self, gen, t_len: int = 24, seed: int = 0, pairs=None):
        from ..models.melody.telemelody import SEP
        self.gen = gen
        self.t = t_len
        self.sep = SEP
        self.pairs = pairs
        self.rng = np.random.RandomState(seed)
        from .toydata import _SYL_TEXT
        self.chars = list(_SYL_TEXT.values())
        trend = gen.trend_dict
        self.chords = [e for e in trend.entries if e.startswith("Chord_")]

    def _frame(self, vocab, src_tokens, tgt_tokens, srcs, ins, outs, i):
        from ..models.melody.vocab import BOS_ID, EOS_ID
        t = self.t
        sids = (vocab[0].encode(src_tokens) + [EOS_ID])[:t]
        tids = vocab[1].encode(tgt_tokens)[: t - 1]
        srcs[i, : len(sids)] = sids
        ins[i, 0] = BOS_ID
        ins[i, 1: len(tids) + 1] = tids
        outs[i, : len(tids)] = tids
        outs[i, len(tids)] = EOS_ID

    def batch(self, bs: int):
        t = self.t
        g = self.gen
        out = {k: np.zeros((bs, t + (0 if k.endswith("_src") else 1)),
                           np.int32)
               for k in ("lyric2rhythm_src", "lyric2rhythm_in",
                         "lyric2rhythm_out", "trend2melody_src",
                         "trend2melody_in", "trend2melody_out")}
        for i in range(bs):
            if self.pairs is not None:
                chars, rhythm, trend, note_toks = self.pairs[
                    self.rng.randint(len(self.pairs))]
                self._frame((g.lyric_dict, g.rhythm_dict),
                            list(chars) + [self.sep],
                            list(rhythm) + [self.sep],
                            out["lyric2rhythm_src"], out["lyric2rhythm_in"],
                            out["lyric2rhythm_out"], i)
                self._frame((g.trend_dict, g.notes_dict), list(trend),
                            list(note_toks), out["trend2melody_src"],
                            out["trend2melody_in"], out["trend2melody_out"],
                            i)
                continue
            n = self.rng.randint(4, 8)
            chars = [str(self.rng.choice(self.chars)) for _ in range(n)]
            rhythm = [str(_stable_hash(c) % 4) for c in chars]
            self._frame((g.lyric_dict, g.rhythm_dict),
                        chars + [self.sep], rhythm + [self.sep],
                        out["lyric2rhythm_src"], out["lyric2rhythm_in"],
                        out["lyric2rhythm_out"], i)
            # generate_melody emits ["MAJ"] + per-note
            # [Chord_x, NOT|HALF|AUT, BEAT_n] (telemelody.py); cover all
            # three section-ender tokens so none is out-of-distribution
            trend, notes = ["MAJ"], []
            for k in range(n):
                chord = str(self.rng.choice(self.chords))
                beat = int(self.rng.randint(4))
                ender = str(self.rng.choice(["NOT", "HALF", "AUT"]))
                trend += [chord, ender, f"BEAT_{beat}"]
                notes += [f"Bar_{k // 4}", f"Pos_{beat * 4}",
                          f"Pitch_{60 + _stable_hash(chord) % 12}", "Dur_4"]
            self._frame((g.trend_dict, g.notes_dict), trend, notes,
                        out["trend2melody_src"], out["trend2melody_in"],
                        out["trend2melody_out"], i)
        return out


class _LyricBatcher:
    """Fixed-shape LM batches in the SERVING layouts, terminated with the
    tokenizer's EOS — targets without EOS train samplers that can never
    stop (LyricGeneratorT5 waits for eos_token_id) and burn the whole
    decode budget on degenerate text.

    - gpt2: '[CLS] kw [SEP] <style> [SEP] text <结束>'
      (LyricGeneratorGPT2.generate prompt layout)
    - t5:   src '关键词：{kw} 长度：{len(text)} <eos>', tgt 'text <eos>'
      (LyricGeneratorT5.generate prompt layout)
    """

    def __init__(self, lines, tokenizer, t_len: int = 64, seed: int = 0,
                 keywords=None, family: str = "t5",
                 style: str = "<Pop 流行>"):
        self.lines, self.tok, self.t = lines, tokenizer, t_len
        self.keywords = keywords
        self.family, self.style = family, style
        self.rng = np.random.RandomState(seed)

    def batch(self, bs: int):
        tok = self.tok
        ids = np.zeros((bs, self.t), np.int32)
        src = np.zeros((bs, 16), np.int32)
        picks = self.rng.choice(len(self.lines), bs)
        for i, p in enumerate(picks):
            kw = (self.keywords[p] if self.keywords
                  else self.lines[p][:2])
            if self.family == "gpt2":
                enc = ([tok.cls_id] + tok.encode(kw) + [tok.sep_id]
                       + [tok.token_id(self.style)] + [tok.sep_id]
                       + tok.encode(self.lines[p]) + [tok.eos_id])
            else:
                enc = tok.encode(self.lines[p]) + [tok.eos_id]
            enc = enc[: self.t]
            ids[i, : len(enc)] = enc
            # EXACT serving prompt (LyricGeneratorT5.generate: length goes
            # into the prompt, reference convention, and the encoder input
            # is EOS-terminated). Using each line's true length trains the
            # digit embeddings the length slot can see at inference; a
            # hardcoded 长度：15 left e.g. '0'/'3' random-init, and one bad
            # draw on those noise states made the decoder emit EOS
            # immediately (empty lyrics).
            kenc = (tok.encode(f"关键词：{kw} 长度：{len(self.lines[p])}")
                    + [tok.eos_id])[:16]
            src[i, : len(kenc)] = kenc
        return {"ids": ids, "src": src, "tgt": ids}


# --------------------------------------------------------------------------
# family wiring
# --------------------------------------------------------------------------

FAMILIES = ("melody_note", "melody_note_prev", "seq2seq", "telemelody",
            "duration_mse", "duration_sdp", "gpt2", "t5")


def build_family(family: str, tiny: bool, data: str | None, seed: int = 0,
                 device=None):
    """(model, loss_fn, batcher) for a family on ``device`` (default
    cuda): the model is a module, or an nn.ModuleDict of the jointly
    trained ones. Weights come from ``seed`` (the global torch RNG is left
    as it was)."""
    import dataclasses

    import torch
    from torch import nn

    from ..device import resolve_device
    from ..frontend import load_lexicon
    from ..models.melody import (MelodyConfig, MSEDurationModel,
                                 MelodyTransformer, SDPDurationConfig,
                                 SDPDurationModel,
                                 lyric_dictionary_from_chars, note_dictionary)
    from . import seq_losses

    device = resolve_device(device)

    def seeded(build):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return build().to(device)

    if family == "seq2seq":
        # the melody_v2 RNN family: three models trained jointly with the
        # serving vocabularies so checkpoints drop into the generator
        from ..models.melody.seq2seq import Seq2SeqConfig
        from ..models.melody.seq2seq_api import (Seq2SeqMelodyGenerator,
                                                 default_langs)
        langs = default_langs()
        cfg = (Seq2SeqConfig(en_embedding_dim=32, de_embedding_dim=32,
                             hidden_dim=32)
               if tiny else Seq2SeqConfig())
        gen = Seq2SeqMelodyGenerator(*langs, cfg=cfg, seed=seed,
                                     device=device)
        # training mode: cuDNN's RNN backward refuses an eval-mode GRU
        models = nn.ModuleDict({"lyric2note": gen.lyric2note,
                                "lyric2duration": gen.lyric2duration,
                                "note2duration": gen.note2duration}).train()
        # n=512: with only 64 pairs the RNNs memorize whole sequences
        # and transpose notes on unseen char combinations; enough
        # diversity forces the per-char mapping to generalize
        pairs = (_melody_pairs_from_transcriptions(data) if data
                 else _toy_melody_pairs(n=512, seed=seed))
        batcher = _Seq2SeqBatcher(pairs, langs, seed=seed)
        return models, seq_losses.seq2seq_family_loss, batcher
    if family == "telemelody":
        from ..models.melody.telemelody import TeleMelodyGenerator
        cfg = (MelodyConfig(n_layers=1, d_model=32, d_ff=64, n_heads=2)
               if tiny else MelodyConfig())
        gen = TeleMelodyGenerator(cfg=cfg, seed=seed, device=device)
        models = nn.ModuleDict({"lyric2rhythm": gen.lyric2rhythm,
                                "trend2melody": gen.trend2melody}).train()
        if data:
            # real rhythm/trend/note streams derived from transcriptions
            # (REMI-grid quantization); longer frames: 4 note tokens per
            # syllable
            batcher = _TeleMelodyBatcher(
                gen, t_len=48, seed=seed,
                pairs=_telemelody_pairs_from_transcriptions(data))
        else:
            batcher = _TeleMelodyBatcher(gen, seed=seed)
        return models, seq_losses.telemelody_family_loss, batcher
    if family in ("melody_note", "melody_note_prev", "duration_mse",
                  "duration_sdp"):
        chars = sorted(load_lexicon().monosyllable.keys())
        ld, nd = lyric_dictionary_from_chars(chars), note_dictionary()
        if family == "melody_note_prev":
            if data:
                # like telemelody: this family trains on constructed
                # prev-dependent pairs; transcriptions carry no
                # cross-sentence structure to learn from
                raise ValueError(
                    "melody_note_prev trains on synthetic prev-conditioned "
                    "pairs; --data is not supported (use family=melody_note "
                    "for transcription data)")
            pairs = _toy_melody_pairs_prev(seed=seed)
        elif data:
            pairs = _melody_pairs_from_transcriptions(data)
        else:
            pairs = _toy_melody_pairs(seed=seed)
        batcher = _MelodyBatcher(pairs, ld, nd, seed=seed)
        if family == "duration_sdp":
            cfg = (SDPDurationConfig(src_vocab=ld.size, hidden_dim=16,
                                     n_layers=1, n_heads=2, pf_dim=32)
                   if tiny else SDPDurationConfig(src_vocab=ld.size))
            return (seeded(lambda: SDPDurationModel(cfg, nll=True)),
                    seq_losses.duration_sdp_loss, batcher)
        # melody_note_prev trains the "concat" channel: the reference's
        # dot-attention one reaches the decoder only through attention
        # weights, and a trained model ignores it (the JAX package's
        # MelodyConfig.prev_mode)
        cfg = dataclasses.replace(
            MelodyConfig(n_layers=1, d_model=32, d_ff=64, n_heads=2)
            if tiny else MelodyConfig(), src_vocab=ld.size,
            tgt_vocab=nd.size,
            prev_mode="concat" if family == "melody_note_prev"
            else "reference")
        if family == "duration_mse":
            return (seeded(lambda: MSEDurationModel(cfg)),
                    seq_losses.duration_mse_loss, batcher)
        return (seeded(lambda: MelodyTransformer(cfg)),
                seq_losses.melody_note_prev_loss
                if family == "melody_note_prev"
                else seq_losses.melody_note_loss, batcher)
    if family not in ("gpt2", "t5"):
        raise ValueError(f"unknown family {family!r}")

    from ..models.lyrics import (GPT2, GPT2Config, T5, default_tokenizer,
                                 t5_config_for)
    tok = default_tokenizer(family, tiny=tiny)
    if data:
        with open(data, encoding="utf-8") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    else:
        lines = _toy_lyric_lines(seed=seed)
    batcher = _LyricBatcher(lines, tok, seed=seed, family=family)
    if family == "gpt2":
        cfg = (GPT2Config(vocab_size=tok.vocab_size, n_layer=1, n_embd=32,
                          n_head=2, n_positions=128) if tiny
               else GPT2Config(vocab_size=tok.vocab_size))
        return seeded(lambda: GPT2(cfg)), seq_losses.lm_loss, batcher
    cfg = (t5_config_for(tok, d_model=32, d_kv=8, d_ff=64, num_layers=1,
                         num_decoder_layers=1, num_heads=4)
           if tiny else t5_config_for(tok))
    return seeded(lambda: T5(cfg)), seq_losses.t5_loss, batcher


def save_seq_checkpoint(path: str, model, opt, step: int) -> None:
    """``path`` (a step_<n>.pt file) holding the model's state_dict
    (``params``), the optimizer's (``opt_state``) and ``step``."""
    import torch
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"params": model.state_dict(), "opt_state": opt.state_dict(),
                "step": step}, path)


def train_family(family: str, steps: int = 100, batch_size: int = 16,
                 lr: float = 3e-4, tiny: bool = False, data=None,
                 ckpt_dir=None, resume=None, log_every: int = 10,
                 seed: int = 0, metrics_writer=None, return_model=False,
                 device=None):
    """Train one family on ``device`` (default cuda); returns the list of
    per-step losses (or ``(losses, model)`` with return_model). With
    ``ckpt_dir`` the last step is saved as {ckpt_dir}/{family}/
    step_<N>.pt; ``resume`` is such a file, and ``steps`` are additional."""
    import torch

    from ..device import resolve_device
    from ..runtime import Prefetcher
    from .data import to_device
    from .seq_losses import SeqOptimizer, make_seq_train_step

    device = resolve_device(device)
    model, loss_fn, batcher = build_family(family, tiny, data, seed, device)
    opt = SeqOptimizer(model.parameters(), lr)
    start_step = 0
    if resume:
        state = torch.load(resume, map_location=device, weights_only=True)
        model.load_state_dict(state["params"])
        opt.load_state_dict(state["opt_state"])
        start_step = int(state["step"])
        print(f"resumed {family} from {resume} at step {start_step}")

    step_fn = make_seq_train_step(loss_fn, model, opt)
    generator = torch.Generator(device).manual_seed(seed + 1)
    losses = []
    t0 = time.time()
    # overlap host batch assembly and the copy with the device step
    with Prefetcher(lambda _s: batcher.batch(batch_size), steps, depth=2,
                    transfer=lambda b: to_device(b, device)) as feed:
        for offset, batch in feed:
            step = start_step + offset
            loss = step_fn(batch, generator)
            losses.append(loss)
            if step % log_every == 0 or step == start_step + steps - 1:
                print(f"[{family}] step {step} loss {float(loss):.4f} "
                      f"({time.time() - t0:.1f}s)")
                if metrics_writer is not None:
                    metrics_writer.write(step, {"loss": loss})
    losses = torch.stack(losses).tolist() if losses else []
    if ckpt_dir:
        path = os.path.join(os.path.abspath(ckpt_dir), family,
                            f"step_{start_step + steps}.pt")
        save_seq_checkpoint(path, model, opt, start_step + steps)
        print(f"saved {path}")
    return (losses, model) if return_model else losses


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m music_generation_tpu_torch.train.seq")
    p.add_argument("--family", required=True, choices=[*FAMILIES, "all"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--data", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", default=None, metavar="FILE",
                   help="a step_<n>.pt of this family; --steps are "
                        "additional")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    families = FAMILIES if args.family == "all" else [args.family]
    writer = None
    if args.ckpt_dir:
        from .metrics import MetricsWriter
        writer = MetricsWriter(os.path.join(args.ckpt_dir, "logs"))
    try:
        for fam in families:
            # telemelody trains on synthetic token streams only; in `all`
            # mode just skip the dataset for it instead of erroring the
            # whole sweep
            fam_data = None if fam == "telemelody" else args.data
            losses = train_family(
                fam, steps=args.steps, batch_size=args.batch_size,
                lr=args.lr, tiny=args.tiny, data=fam_data,
                ckpt_dir=args.ckpt_dir, resume=args.resume,
                log_every=args.log_every, seed=args.seed,
                metrics_writer=writer, device=args.device)
            print(f"[{fam}] first {losses[0]:.4f} -> last {losses[-1]:.4f}")
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
