"""TeleMelody (the v1_model melody family): lyric->rhythm and trend->melody
twin transformers, REMI-style decoding and MIDI assembly.

Twin of music_generation_tpu/models/melody/telemelody.py:
  - lyric2rhythm: the syllable stream with [sep] -> a beat label per
    syllable (sampled: top-k 2, temperature 0.5);
  - the trend string: 'MAJ' + per note 'Chord_X  NOT|HALF|AUT  BEAT_n',
    the fixed chord progression cycled per bar;
  - trend2melody: trend tokens -> a 'Bar_/Pos_/Pitch_/Dur_' stream
    (sampled: top-k 10), fixed into strict 4-token groups, octave and grid
    regularised (adapt_e), then a melody track, a block-chord piano track
    and lyric events; the durations read back as ticks / 1000 seconds.
The two models are the port's MelodyTransformer with their own
vocabularies; the sampled decode runs on the device, the REMI and MIDI
post-processing on the host, as in the JAX package. The random stream is a
torch.Generator seeded from seed + 1 (the JAX package's PRNGKey(seed + 1)):
its draws are not JAX's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from ...audio.midi import Note, Track
from ...device import resolve_device
from ...frontend import load_lexicon, midi_to_note
from .beam import sample_decode
from .transformer import MelodyConfig, MelodyTransformer, causal_mask
from .vocab import BOS_ID, EOS_ID, MelodyDictionary

SEP = "[sep]"
WORD = "[WORD]"
POS_RESOLUTION = 4
MIN_OCT, MAX_OCT = 5, 6
C2, C3 = 36, 48
NO_CHORD = "N.C."
TICKS_PER_BEAT = 480

_PITCH_CLASS_NAMES = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A",
                      "Bb", "B"]
PITCH_CLASS = {n: i for i, n in enumerate(_PITCH_CLASS_NAMES)}
CHORD_KIND_PITCHES = {
    "": [0, 4, 7], "m": [0, 3, 7], "+": [0, 4, 8], "dim": [0, 3, 6],
    "7": [0, 4, 7, 10], "maj7": [0, 4, 7, 11], "m7": [0, 3, 7, 10],
    "m7b5": [0, 3, 6, 10],
}
DEFAULT_CHORDS = "C: G: C: E: G: C: F: C: F: A:"


def process_lyrics(lyrics: str) -> str:
    """Char-spaced lyric stream with [sep] at punctuation and at the end."""
    punct = set(",.!，。！？?；;、")
    return " ".join([SEP if w in punct else w for w in lyrics] + [SEP])


def rhythm_vocab() -> MelodyDictionary:
    return MelodyDictionary((SEP, WORD, "0", "1", "2", "3"))


def trend_vocab() -> MelodyDictionary:
    entries = ["MAJ", "MIN", "NOT", "HALF", "AUT"]
    entries += [f"BEAT_{i}" for i in range(4)]
    for root in _PITCH_CLASS_NAMES:
        for kind in CHORD_KIND_PITCHES:
            entries.append(f"Chord_{root}:{kind}")
    return MelodyDictionary(tuple(entries))


def notes_vocab() -> MelodyDictionary:
    entries = [f"Bar_{i}" for i in range(64)]
    entries += [f"Pos_{i}" for i in range(16)]
    entries += [f"Pitch_{i}" for i in range(40, 96)]
    entries += [f"Dur_{i}" for i in range(1, 17)]
    return MelodyDictionary(tuple(entries))


def adapt(pattern: list[list[list[int]]]) -> list[list[list[int]]]:
    """Rhythm regulariser, in place: a section of a length seen before
    reuses that section's beats (the reference's random reuse always
    fires); otherwise its beats are shifted onto a regular grid."""
    num_dict: dict[int, list[int]] = {}
    prev: list[int] = []
    for sent_idx, sent in enumerate(pattern):
        for sep_idx, sep in enumerate(sent):
            cur_len = len(sep)
            if cur_len in num_dict:
                cur_starts = num_dict[cur_len]
                prev.extend(cur_starts)
            else:
                offset = 0
                if prev and (sep[0] - prev[-1]) % 4 <= 1:
                    offset = sep[0] - prev[-1] + 2
                cur_beats = (sep[0] - offset) % 4
                new_sent = [cur_beats]
                for item in sep[1:]:
                    if (item - offset - cur_beats) % 4 >= 2:
                        offset += (item - offset - cur_beats) % 4 - 1
                    if (len(prev) >= 4 and len(set(prev[-4:])) == 1
                            and prev[-1] == (item - offset) % 4):
                        offset -= 1
                    new_sent.append((item - offset) % 4)
                    prev.append((item - offset) % 4)
                    cur_beats = new_sent[-1]
                cur_starts = new_sent
                num_dict[cur_len] = cur_starts
            pattern[sent_idx][sep_idx] = cur_starts
    return pattern


def adapt_e(e: list[tuple], align_idxs: list[int]) -> list[tuple]:
    """Note regulariser: octave clamp, 16th-note grid, no rest inside a
    word, empty bars removed. ``e`` holds (bar, pos, program, pitch, dur,
    velocity, time signature, tempo) tuples."""
    tmp = [list(i) for i in e]
    last_pos = 0
    for i, note in enumerate(tmp):
        if note[3] <= MIN_OCT * 12:
            note[3] = MIN_OCT * 12 + note[3] % 12
        elif note[3] >= MAX_OCT * 12 + 12:
            note[3] = MAX_OCT * 12 + note[3] % 12
        if note[1] % 2 == 1 and last_pos <= (16 * note[0] + note[1] - 1):
            note[1] -= 1
        if note[4] != 1 and (note[1] + note[4]) % 2 == 1:
            note[4] -= 1
        if last_pos >= 16 * note[0] + note[1] and i > 0:
            tmp[i - 1][4] -= last_pos - (16 * note[0] + note[1])
        last_pos = 16 * note[0] + note[1] + note[4]

    words, cur_word = [], []
    for idx, note in enumerate(tmp):
        if idx != 0 and idx in align_idxs and cur_word:
            words.append(cur_word)
            cur_word = []
        cur_word.append(note)
    if cur_word:
        words.append(cur_word)
    tmp = []
    for notes in words:
        first = notes[0]
        last_pos = 16 * first[0] + first[1] + first[4]
        tmp.append(first)
        for note in notes[1:]:
            note[0] = last_pos // 16
            note[1] = last_pos % 16
            tmp.append(note)
            last_pos += note[4]

    last_pos, offset = 0, 0
    for note in tmp:
        cur_pos = 16 * (note[0] + offset) + note[1]
        while cur_pos - last_pos >= 16:
            offset -= 1
            cur_pos -= 16
        note[0] += offset
        last_pos = cur_pos + note[4]
    return [tuple(i) for i in tmp]


@dataclass
class TeleMelodyResult:
    melody: Track
    chords: Track
    durations: list[float]
    pitches: list[str]
    tracks: list[Track] = field(default_factory=list)


class TeleMelodyGenerator:
    """The two transformers (``cfg``'s widths, each with its own
    vocabularies) on ``device`` (default cuda), weights from ``seed``."""

    def __init__(self, cfg: Optional[MelodyConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.rhythm_dict = rhythm_vocab()
        self.trend_dict = trend_vocab()
        self.notes_dict = notes_vocab()
        # char-level lyric vocabulary: the monosyllable charset, sorted
        self.lyric_dict = MelodyDictionary(
            (SEP, WORD) + tuple(sorted(load_lexicon().monosyllable.keys())))
        base = cfg or MelodyConfig()
        self.l2r_cfg = dataclasses.replace(
            base, src_vocab=self.lyric_dict.size,
            tgt_vocab=self.rhythm_dict.size)
        self.t2m_cfg = dataclasses.replace(
            base, src_vocab=self.trend_dict.size,
            tgt_vocab=self.notes_dict.size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.lyric2rhythm = MelodyTransformer(self.l2r_cfg)
            self.trend2melody = MelodyTransformer(self.t2m_cfg)
        self.lyric2rhythm.to(self.device).eval()
        self.trend2melody.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)

    @torch.no_grad()
    def _sample(self, model: MelodyTransformer, src_ids: list[int],
                max_len: int, top_k: int, temperature: float,
                min_len: int) -> list[int]:
        """sample_decode of ``model`` on src_ids + [EOS], cut at its EOS."""
        src = torch.tensor([src_ids + [EOS_ID]], device=self.device)
        src_attn = (src != 0)[:, None, None, :].to(torch.int32)
        memory = model.encode(src, src_attn)
        tgt_mask = causal_mask(max_len + 1, device=self.device)

        def decode_logits(seqs, step):
            out = model.decode(memory, src_attn, seqs, tgt_mask)
            return model.logits(out[:, step])

        out = sample_decode(decode_logits, max_len, BOS_ID, EOS_ID,
                            top_k=top_k, temperature=temperature,
                            min_len=min_len, generator=self.generator,
                            device=self.device).tolist()
        return out[: out.index(EOS_ID)] if EOS_ID in out else out

    def generate_melody(self, sents: str,
                        bar_chords: str = DEFAULT_CHORDS) -> TeleMelodyResult:
        """sents: a process_lyrics stream, '明 月 几 时 有 [sep] 把 酒 ...'."""
        sents = sents.strip()
        chords_list = []
        for item in bar_chords.split():
            if (len(chords_list) >= 2 and item == chords_list[-1]
                    and item == chords_list[-2]):
                continue
            chords_list.append(item)

        tmp, align_idxs = [], []
        cur_period, cur_length = False, 0
        for item in sents.split():
            if item == SEP:
                if cur_length <= 0:
                    continue
                cur_length = 0
                tmp.append("." if cur_period else ",")
                cur_period = not cur_period
            else:
                if item[0] != "@":
                    align_idxs.append(
                        len([i for i in tmp if i not in (",", ".")]))
                tmp.append(item)
                cur_length += 1
        if not tmp:
            tmp = ["."]
        if tmp[-1] != ".":
            tmp[-1] = "."
        word_num = len([i for i in tmp if i not in (",", ".")])
        if word_num == 0:
            raise ValueError("no syllables in input")

        # lyric -> beats (top-k 2, temperature 0.5)
        src_ids = self.lyric_dict.encode(sents.split())
        n_src = len(src_ids)
        beat_tokens = self._sample(self.lyric2rhythm, src_ids,
                                   max_len=max(n_src, 4), top_k=2,
                                   temperature=0.5, min_len=n_src)
        beats_label = []
        for tok in self.rhythm_dict.decode_ids(beat_tokens):
            if tok in (SEP, WORD):
                continue
            try:
                beats_label.append([int(tok)])
            except ValueError:
                beats_label.append([beats_label[-1][0]] if beats_label
                                   else [0])
            if len(beats_label) == word_num:
                break
        while len(beats_label) < word_num:
            beats_label.append([beats_label[-1][0]] if beats_label else [0])

        # beat pattern -> trend string
        pattern, cur_sent, cur_sep = [], [], []
        word_idx = 0
        for word in tmp:
            if word not in (",", "."):
                cur_sep.extend(beats_label[word_idx])
                word_idx += 1
            elif word == ",":
                if cur_sep:
                    cur_sent.append(cur_sep)
                    cur_sep = []
            else:
                if cur_sep:
                    cur_sent.append(cur_sep)
                    cur_sep = []
                if cur_sent:
                    pattern.append(cur_sent)
                    cur_sent = []
        pattern = adapt(pattern)

        bar_int = len(chords_list)
        words, chords = ["MAJ"], []
        cur_bar = 0
        for sent in pattern:
            for sect_idx, section in enumerate(sent):
                next_bar = False
                cur_chord = chords_list[cur_bar % bar_int]
                for idx, beat in enumerate(section):
                    if next_bar:
                        cur_bar += 1
                        cur_chord = chords_list[cur_bar % bar_int]
                    next_bar = False
                    words.append(f"Chord_{cur_chord}")
                    chords.append(cur_chord)
                    if idx != len(section) - 1:
                        words.append("NOT")
                        if section[idx] > section[idx + 1]:
                            next_bar = True
                    elif sect_idx == len(sent) - 1:
                        words.append("AUT")
                    else:
                        words.append("HALF")
                    words.append(f"BEAT_{beat}")
                cur_bar += 1

        # trend -> note tokens (top-k 10, temperature 0.5)
        trend_ids = self.trend_dict.encode(words)
        n_trend = len(trend_ids)
        min_len = max((n_trend - 1) * 4 // 3, 4)
        max_len = max(int(n_trend * 4 / 3) + 8, min_len + 4)
        note_tokens = self._sample(self.trend2melody, trend_ids,
                                   max_len=max_len, top_k=10,
                                   temperature=0.5, min_len=min_len)

        target = ["Bar", "Pos", "Pitch", "Dur"]
        enc, i = [], 0
        for tok in self.notes_dict.decode_ids(note_tokens):
            if tok.split("_")[0] == target[i]:
                enc.append(tok)
                i = (i + 1) % 4
        nums = [int("".join(filter(str.isdigit, t))) for t in enc]
        e = [(nums[j], nums[j + 1], 0, nums[j + 2], nums[j + 3], 127 // 4,
              0, 0) for j in range(0, len(nums) // 4 * 4, 4)]
        if not e:
            # degenerate sample: one quarter note per word on C5
            e = [(k // 4, (k % 4) * 4, 0, 60, 4, 31, 0, 0)
                 for k in range(word_num)]
        min_bar = min(i[0] for i in e)
        e = [tuple(k - min_bar if j == 0 else k for j, k in enumerate(i))
             for i in e]
        e.sort()
        e = e[:word_num]
        while len(e) < word_num:  # repair short samples
            last = list(e[-1])
            pos = 16 * last[0] + last[1] + last[4]
            e.append((pos // 16, pos % 16, 0, last[3], last[4], last[5], 0,
                      0))
        e = adapt_e([tuple(i) for i in e], align_idxs)

        # chord lattice over half-bars
        note_chords: list[str] = []
        for chord, note in zip(chords, e):
            cur_idx = note[0] * 2 + (1 if note[1] >= POS_RESOLUTION * 2
                                     else 0)
            if len(note_chords) < cur_idx:
                note_chords += [NO_CHORD] * (cur_idx - len(note_chords))
            if len(note_chords) == cur_idx:
                note_chords.append(chord)
            elif (len(note_chords) == cur_idx + 1
                  and note_chords[-1] == NO_CHORD):
                note_chords[-1] = chord
        for i in range(1, len(note_chords)):
            if note_chords[i] == NO_CHORD:
                note_chords[i] = note_chords[i - 1]

        def tick(bar, pos):
            return (bar * 16 + pos) * TICKS_PER_BEAT // POS_RESOLUTION

        melody = Track(name="melody", program=40)  # violin
        for bar, pos, _prog, pitch, dur, vel, _ts, _tpo in e:
            start = tick(max(bar, 0), pos)
            melody.notes.append(Note(pitch=pitch, start=start,
                                     end=start + tick(0, dur),
                                     velocity=vel * 4 + 2))
        melody.notes.sort(key=lambda n: (n.start, -n.end))

        # lyric events on the notes
        lyr_words: list[str] = []
        for word in tmp:
            if word not in (",", "."):
                lyr_words.append(word)
            elif lyr_words:
                lyr_words[-1] += word
        for widx, word in enumerate(lyr_words):
            if widx < len(align_idxs) and align_idxs[widx] < len(
                    melody.notes):
                melody.lyrics.append(
                    (melody.notes[align_idxs[widx]].start, word))

        chord_track = Track(name="chord", program=0)
        for idx, chord in enumerate(note_chords):
            if chord == NO_CHORD:
                continue
            root_name, kind = chord.split(":")
            root = PITCH_CLASS[root_name]
            s, en = idx * 2 * TICKS_PER_BEAT, (idx * 2 + 2) * TICKS_PER_BEAT
            chord_track.notes.append(Note(C2 + root, s, en, 80))
            for shift in CHORD_KIND_PITCHES[kind]:
                chord_track.notes.append(
                    Note(C3 + (root + shift) % 12, s, en, 80))

        durations = [(n.end - n.start) / 1000.0 for n in melody.notes]
        pitches = [midi_to_note(n.pitch) for n in melody.notes]
        return TeleMelodyResult(melody=melody, chords=chord_track,
                                durations=durations, pitches=pitches,
                                tracks=[melody, chord_track])

    def get_melody(self, lyrics: str):
        """(result, durations, pitches) of a lyric line."""
        result = self.generate_melody(process_lyrics(lyrics))
        return result, result.durations, result.pitches
