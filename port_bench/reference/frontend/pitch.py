"""Pitch utilities: note-name <-> MIDI, coarse F0 quantization.

Self-contained replacements for the reference's librosa calls
(librosa.note_to_midi / midi_to_note at pipline_inference*.py and
cpop_text_preprocessor.py:86) and f0_to_coarse
(VISinger/utils/pitch_utils.py:22-32).
"""

from __future__ import annotations

import re

import numpy as np

_PITCH_CLASS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_NOTE_RE = re.compile(r"^([A-Ga-g])([#♯b!♭𝄪𝄫]*)(-?\d+)?$")
_NAMES_SHARP = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

F0_BIN = 256
F0_MIN, F0_MAX = 50.0, 1100.0
_F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
_F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def note_to_midi(note: str) -> int:
    """'C4' -> 60, 'G#3' -> 56. Accepts #/b accidentals; octave defaults to 0."""
    m = _NOTE_RE.match(note.strip())
    if m is None:
        raise ValueError(f"bad note name: {note!r}")
    letter, accidentals, octave = m.groups()
    semis = _PITCH_CLASS[letter.upper()]
    for a in accidentals:
        semis += {"#": 1, "♯": 1, "𝄪": 2, "b": -1, "!": -1, "♭": -1, "𝄫": -2}[a]
    oct_num = int(octave) if octave is not None else 0
    return 12 * (oct_num + 1) + semis


def midi_to_note(midi: int) -> str:
    """60 -> 'C4' (sharps spelling, ASCII)."""
    midi = int(round(midi))
    octave, pc = divmod(midi, 12)
    return f"{_NAMES_SHARP[pc]}{octave - 1}"


def note_id(note: str) -> int:
    """SVS note embedding id: MIDI number with octaves 5/6 clamped to 4;
    'rest' -> 0. Parity with cpop_text_preprocessor.format_note (:79-87)."""
    if note == "rest":
        return 0
    name = note.split("/")[0].replace("5", "4").replace("6", "4")
    return note_to_midi(name)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize F0 (Hz) into 256 mel-spaced bins; bin 1 = unvoiced floor."""
    f0 = np.asarray(f0, dtype=np.float64)
    mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = np.where(
        mel > 0,
        (mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1.0,
        mel,
    )
    scaled = np.clip(scaled, 1.0, F0_BIN - 1)
    return np.rint(scaled).astype(np.int32)
