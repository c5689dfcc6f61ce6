"""Score alignment: (lyrics, note names, note durations) -> model input arrays.

This is the host-side preparation step in front of the SVS model: normalize the
sentence to tone-marked phonemes, split each syllable into initial+final with
the note/duration duplicated across both phones, then map everything to ids.
Parity with Synthesiser.process_input_data / get_text
(pipline_inference_svs_v6_multispeaker.py:58-126).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .g2p import normalize_text
from .lexicon import Lexicon, load_lexicon
from .pitch import note_id
from .vocab import PhonemeVocab, phone_vocab, shengdiao_vocab, split_syllable

_TONE_RE = re.compile(r"[12345]")


@dataclass(frozen=True)
class ScoreInputs:
    """Dense per-phone inputs for one sentence (numpy, unbatched)."""
    phone_ids: np.ndarray        # int32 [T] toneless phone ids
    note_ids: np.ndarray         # int32 [T] MIDI note ids (0 = rest)
    note_durations: np.ndarray   # float32 [T] seconds
    shengdiao_ids: np.ndarray    # int32 [T] tone-marked phone ids
    phonemes: tuple[str, ...]    # tone-marked phoneme strings (debugging)
    # int32 [T] syllable index per phone (split points for over-long
    # sentences must not separate an initial from its final); defaults to
    # one syllable per phone for hand-built scores
    syllable_idx: np.ndarray | None = None

    def syllable_bounds(self) -> np.ndarray:
        """Phone positions where a new syllable starts (always includes 0)."""
        if self.syllable_idx is None:
            return np.arange(len(self.phone_ids), dtype=np.int32)
        d = np.diff(self.syllable_idx, prepend=self.syllable_idx[:1] - 1)
        return np.flatnonzero(d != 0).astype(np.int32)

    def slice_phones(self, lo: int, hi: int) -> "ScoreInputs":
        """Sub-score over phone positions [lo, hi)."""
        return ScoreInputs(
            phone_ids=self.phone_ids[lo:hi],
            note_ids=self.note_ids[lo:hi],
            note_durations=self.note_durations[lo:hi],
            shengdiao_ids=self.shengdiao_ids[lo:hi],
            phonemes=self.phonemes[lo:hi],
            syllable_idx=(None if self.syllable_idx is None
                          else self.syllable_idx[lo:hi]))


class ScoreFrontend:
    """Stateful bundle of the lexicon + both phoneme vocabularies."""

    def __init__(self, lexicon: Lexicon | None = None):
        self.lexicon = lexicon or load_lexicon()
        self.phones: PhonemeVocab = phone_vocab()
        self.shengdiao: PhonemeVocab = shengdiao_vocab()

    def _safe_units(self, syl: str) -> tuple[str, ...]:
        """split_syllable with OOV repair: a unit that neither vocabulary
        can encode (e.g. G2P residue of latin letters or lexicon data
        defects in LM-generated lyrics) becomes an SP pause instead of a
        KeyError deep inside the request handler — failures are repaired,
        not raised (the reference's melody-repair philosophy, SURVEY §5)."""
        units = (syl,) if syl in ("SP", "AP") else split_syllable(syl)
        return tuple(
            u if (self.shengdiao.contains(u)
                  and self.phones.contains(_TONE_RE.sub("", u)))
            else "SP"
            for u in units)

    def align(self, text: str, notes: list[str], note_durations: list[float]) -> ScoreInputs:
        """Phonemize `text` and expand notes/durations across split syllables.

        `notes`/`note_durations` must have one entry per syllable/pause of the
        normalized text (same contract as the reference pipelines).
        """
        phonemes = normalize_text(text, word_parse=False, lexicon=self.lexicon)
        phonemes = phonemes.replace(".", "").strip()
        syllables = phonemes.replace("s p", "SP").replace("a p", "AP").split(" ")

        ph_seq: list[str] = []
        out_notes: list[str] = []
        out_durs: list[float] = []
        syl_idx: list[int] = []
        for pos, syl in enumerate(syllables):
            units = self._safe_units(syl)
            # melody length mismatches are REPAIRED, not failed (reference
            # convention, transformer_melody/inference.py handle_notes /
            # Melody/seq2seq/get_melody.py:284-295): syllables beyond the
            # notes list reuse the last note/duration
            note = notes[pos] if pos < len(notes) else notes[-1]
            dur = (note_durations[pos] if pos < len(note_durations)
                   else note_durations[-1])
            ph_seq.extend(units)
            out_notes.extend([note] * len(units))
            out_durs.extend([float(dur)] * len(units))
            syl_idx.extend([pos] * len(units))

        tone_str = " ".join(ph_seq).replace(",", "SP")
        plain_str = _TONE_RE.sub("", tone_str)

        return ScoreInputs(
            phone_ids=np.asarray(self.phones.encode(plain_str), dtype=np.int32),
            note_ids=np.asarray([note_id(n) for n in out_notes], dtype=np.int32),
            note_durations=np.asarray(out_durs, dtype=np.float32),
            shengdiao_ids=np.asarray(self.shengdiao.encode(tone_str), dtype=np.int32),
            phonemes=tuple(tone_str.split(" ")),
            syllable_idx=np.asarray(syl_idx, dtype=np.int32),
        )

    def align_template(self, text: str):
        """Phonemize `text` and return the phone->syllable index map instead
        of consuming notes (for pipelines whose notes/durations materialize
        on-device): (phone_ids, shengdiao_ids, syllable_idx, n_syllables),
        all int32 numpy."""
        phonemes = normalize_text(text, word_parse=False, lexicon=self.lexicon)
        phonemes = phonemes.replace(".", "").strip()
        syllables = phonemes.replace("s p", "SP").replace("a p", "AP").split(" ")

        ph_seq: list[str] = []
        syl_idx: list[int] = []
        for pos, syl in enumerate(syllables):
            units = self._safe_units(syl)
            ph_seq.extend(units)
            syl_idx.extend([pos] * len(units))

        tone_str = " ".join(ph_seq).replace(",", "SP")
        plain_str = _TONE_RE.sub("", tone_str)
        return (np.asarray(self.phones.encode(plain_str), np.int32),
                np.asarray(self.shengdiao.encode(tone_str), np.int32),
                np.asarray(syl_idx, np.int32),
                len(syllables))

    def align_pipe_format(self, line: str) -> ScoreInputs:
        """Parse the reference's 'name|lyrics|pitches|durations' text format
        (pipline_inference_svs_v6_multispeaker.py:97-105)."""
        metas = line.split("|")
        text = metas[1].replace(" ", "")
        notes = metas[2].split(" ")
        durs = [float(x) for x in metas[3].split(" ")]
        return self.align(text, notes, durs)
