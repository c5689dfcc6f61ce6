"""Host API for the seq2seq (melody_v2) family: LyricMelody.get_melody.

Twin of music_generation_tpu/models/melody/seq2seq_api.py, after
Melody/seq2seq/get_melody.py:273-360 of the reference: strip commas,
lyric->note beam-5 decode, note->duration decode, pad repairs (repeat the
last note / mean duration 0.4202), then SP/AP breath insertion: at commas
(rest/rest + 0.2102/0.3024) or, for a comma-free line longer than 6
characters, at one position drawn from random.Random(seed), always with a
trailing AP.

Deviations of the JAX twin that the port keeps: both comma forms are
stripped (the reference strips only the full-width one), and the breath
position comes from a seeded PRNG.

Random init departs from the JAX twin in one place,
_readable_random_head: each model's linear2 bias starts at -10 for _PAD_,
_UNK_ and _START_, so an untrained model decodes real note and duration
tokens (a note model emitting "_PAD_" would leave the score frontend a
note it cannot read). Trained weights replace the bias.
"""

from __future__ import annotations

import random
from typing import Optional

import torch

from ...device import resolve_device
from .seq2seq import (EOS_ID, PAD_ID, START_ID, UNK_ID, Lang, Seq2SeqConfig,
                      Seq2SeqModel, beam_decode)

MEAN_DURATION = 0.4202
COMMA_SP, COMMA_AP = 0.2102, 0.3024
INSERT_SP, INSERT_AP = 0.1104, 0.3104


def _readable_random_head(model: Seq2SeqModel) -> None:
    """Bias a random model's output away from _PAD_, _UNK_ and _START_
    (-10), so its decodes are note and duration tokens the pipeline can
    read. The JAX package's random models lack this."""
    with torch.no_grad():
        model.decoder.linear2.bias[[PAD_ID, UNK_ID, START_ID]] = -10.0


class Seq2SeqMelodyGenerator:
    """Three seq2seq models: lyric2note, lyric2duration, note2duration
    (built from seed, seed + 1 and seed + 2)."""

    def __init__(self, lyric_lang: Lang, note_lang: Lang, duration_lang: Lang,
                 cfg: Optional[Seq2SeqConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.lyric_lang = lyric_lang
        self.note_lang = note_lang
        self.duration_lang = duration_lang
        base = cfg or Seq2SeqConfig()
        self._rand = random.Random(seed)

        def build(en_vocab, de_vocab, model_seed):
            c = Seq2SeqConfig(**{**base.__dict__,
                                 "en_vocab": en_vocab, "de_vocab": de_vocab})
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(model_seed)
                m = Seq2SeqModel(c)
            _readable_random_head(m)
            return m.to(self.device).eval()

        self.lyric2note = build(lyric_lang.n_items, note_lang.n_items, seed)
        self.lyric2duration = build(lyric_lang.n_items, duration_lang.n_items,
                                    seed + 1)
        self.note2duration = build(note_lang.n_items, duration_lang.n_items,
                                   seed + 2)

    @staticmethod
    def _len_bucket(n: int) -> int:
        for b in (8, 16, 32, 64, 128):
            if n <= b:
                return b
        return 128

    def _decode(self, model: Seq2SeqModel, src_lang: Lang, tgt_lang: Lang,
                tokens: list[str], max_len: int) -> list[str]:
        ids = src_lang.encode(tokens)
        n_pad = self._len_bucket(len(ids) + 1)
        # keep EOS even when the input exceeds the largest bucket
        ids = ids[: n_pad - 1] + [EOS_ID]
        ids = ids + [0] * (n_pad - len(ids))
        src = torch.tensor([ids], dtype=torch.int64, device=self.device)
        seq, _ = beam_decode(model, src, max_len=self._len_bucket(max_len),
                             beam=5)
        out = []
        for t in tgt_lang.decode(seq.cpu().tolist()):
            if t == "_EOS_":
                break
            out.append(t)
        return out

    def get_melody(self, lyrics: str):
        """Returns (lyrics_with_breaths, note names, durations seconds)."""
        content = lyrics.replace(",", "").replace("，", "")
        chars = list(content)
        max_len = len(chars)

        notes = self._decode(self.lyric2note, self.lyric_lang, self.note_lang,
                             chars, max_len)
        if not notes:
            notes = ["C4"]
        while len(notes) < max_len:
            notes.append(notes[-1])
        notes = notes[:max_len]

        durs_tok = self._decode(self.note2duration, self.note_lang,
                                self.duration_lang, notes, max_len)
        durations = []
        for t in durs_tok:
            try:
                durations.append(float(t))
            except ValueError:
                durations.append(MEAN_DURATION)
        while len(durations) < max_len:
            durations.append(MEAN_DURATION)
        durations = durations[:max_len]

        if "," in lyrics or "，" in lyrics:
            re_lyrics, new_notes, new_durs = [], [], []
            i = 0
            for ch in lyrics:
                if ch not in (",", "，"):
                    re_lyrics.append(ch)
                    new_notes.append(notes[i])
                    new_durs.append(durations[i])
                    i += 1
                else:
                    new_notes.extend(["rest", "rest"])
                    re_lyrics.extend(["SP", "AP"])
                    new_durs.extend([COMMA_SP, COMMA_AP])
            return "".join(re_lyrics), new_notes, new_durs

        out_chars = list(lyrics)
        if len(out_chars) > 6:
            idx = self._rand.randrange(1, len(out_chars) - 1)
            out_chars.insert(idx, "SP")
            notes.insert(idx, "rest")
            durations.insert(idx, INSERT_SP)
            out_chars.insert(idx + 1, "AP")
            notes.insert(idx + 1, "rest")
            durations.insert(idx + 1, INSERT_AP)
        lyrics_out = "".join(out_chars) + "AP"
        notes.append("rest")
        durations.append(INSERT_AP)
        return lyrics_out, notes, durations


def default_langs() -> tuple[Lang, Lang, Lang]:
    """Deterministic vocabularies (the reference pickles are lost), read
    from the port's own lexicon copy."""
    from ...frontend import load_lexicon, midi_to_note
    lyric = Lang(sorted(load_lexicon().monosyllable.keys()))
    note = Lang([midi_to_note(m) for m in range(48, 84)] + ["rest"])
    duration = Lang([f"{d / 100:.4f}" for d in range(10, 101, 2)])
    return lyric, note, duration
