"""Pure-Python Mandarin text front-end (G2P, vocabularies, score alignment).

Everything here runs on the host CPU; the outputs are dense integer/float
arrays handed to the device programs.
"""

from .align import ScoreFrontend, ScoreInputs
from .g2p import graphemes_to_phonemes, normalize_text
from .lexicon import Lexicon, load_lexicon
from .numbers_cn import normalize_numbers
from .pitch import f0_to_coarse, midi_to_note, note_id, note_to_midi
from .symbols_cn import normalize_symbols
from .vocab import (PhonemeSeqEncoder, PhonemeVocab, SHENG_MU, phone_vocab,
                    shengdiao_vocab, split_syllable)

__all__ = [
    "Lexicon", "load_lexicon", "normalize_numbers", "normalize_symbols",
    "graphemes_to_phonemes", "normalize_text", "PhonemeVocab", "PhonemeSeqEncoder",
    "phone_vocab", "shengdiao_vocab", "split_syllable", "SHENG_MU",
    "note_to_midi", "midi_to_note", "note_id", "f0_to_coarse",
    "ScoreFrontend", "ScoreInputs",
]
