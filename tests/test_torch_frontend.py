"""Golden tests of the port's G2P front end (music_generation_tpu_torch.
frontend, host code the port keeps its own copy of): the reference's
goldens (tests/fixtures/frontend_goldens.json) and the unit checks that
tests/test_frontend.py applies to the JAX package's front end, applied
here in the same way, so the two copies cannot drift apart."""

import json
import os

import numpy as np
import pytest

from music_generation_tpu_torch.frontend import (
    PhonemeSeqEncoder, ScoreFrontend, normalize_numbers, normalize_symbols,
    normalize_text, note_id, note_to_midi, midi_to_note, phone_vocab,
    shengdiao_vocab, split_syllable, f0_to_coarse,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "frontend_goldens.json")


@pytest.fixture(scope="module")
def goldens():
    with open(FIXTURES, encoding="utf-8") as f:
        return json.load(f)


def test_normalize_matches_reference(goldens):
    for text, want in goldens["normalize"].items():
        assert normalize_text(text) == want, text


def test_numbers_match_reference(goldens):
    for text, want in goldens["numbers"].items():
        assert normalize_numbers(text) == want, text


def test_symbols_match_reference(goldens):
    for text, want in goldens["symbols"].items():
        got = normalize_symbols(normalize_numbers(text.lower()))
        assert got == want, text


def test_negative_numbers_fixed_not_crashing():
    # The reference raises TypeError here; we read the sign.
    assert "零下三度" in normalize_numbers("气温-3度")
    assert normalize_numbers("-5个") .startswith("负五")


def test_all_punct_tail_fixed():
    # Reference returns None for all-punctuation input; we return '.'.
    assert normalize_symbols("，，。") == "."


def test_phone_vocab_ids():
    pv = phone_vocab()
    assert pv.size == 64  # 61 + 3 reserved
    # First data token gets id 3 (after <pad>/<EOS>/<UNK>).
    assert pv.encode("AP") == [3]
    assert pv.encode("ve") == pv.encode("ue")  # canonicalization


def test_shengdiao_vocab_roundtrip():
    sv = shengdiao_vocab()
    assert sv.size == 250
    ids = sv.encode("sh eng1 SP AP")
    assert sv.decode(ids) == "sh eng1 SP AP"


def test_split_syllable():
    assert split_syllable("sheng1") == ("sh", "eng1")
    assert split_syllable("a5") == ("a5",)
    assert split_syllable("wo3") == ("w", "o3")
    assert split_syllable(",") == (",",)


def test_phoneme_seq_encoder_char_alignment():
    enc = PhonemeSeqEncoder()
    text = "ni3 hao3 ,"
    ids = enc.encode(text)
    assert len(ids) == len(text)


def test_note_conversions():
    assert note_to_midi("C4") == 60
    assert note_to_midi("G#3") == 56
    assert note_to_midi("Bb2") == 46
    assert midi_to_note(60) == "C4"
    assert midi_to_note(56) == "G#3"
    assert note_id("rest") == 0
    assert note_id("C5") == note_id("C4")  # octave clamp 5->4
    assert note_id("A6") == note_id("A4")


def test_f0_to_coarse_range():
    f0 = np.array([0.0, 50.0, 220.0, 440.0, 1100.0, 2000.0])
    c = f0_to_coarse(f0)
    assert c.min() >= 1 and c.max() <= 255
    assert c[1] == 1  # f0_min maps to lowest voiced bin


def test_score_frontend_alignment():
    sf = ScoreFrontend()
    line = ("test10|啊,你是我最心爱的姑娘AP|G#3 A3 A3 A3 A3 G#3 D4 D4 E4 E4 B3 rest"
            "|0.44 0.33 0.29 0.4 0.26 0.29 0.6 0.46 0.4 0.84 0.79 0.6")
    s = sf.align_pipe_format(line)
    n = len(s.phone_ids)
    assert n == len(s.note_ids) == len(s.note_durations) == len(s.shengdiao_ids)
    # 啊(1) + ,(1) + 8 two-phone syllables + 爱->ai4(1) + AP(1) = 20
    assert n == 20
    assert s.note_ids[-1] == 0  # rest
    # split syllables share the note of their syllable
    assert s.note_ids[2] == s.note_ids[3] == note_to_midi("A3")


def test_word_parse_matches_reference(goldens):
    """jieba segmentation + '#' joins + sharp collapse
    (text_normalizer.py:32-46 with word_parse=True)."""
    pytest.importorskip("jieba")
    from music_generation_tpu_torch.frontend import normalize_text
    for text, want in goldens["normalize_word_parse"].items():
        assert normalize_text(text, word_parse=True) == want, text


def test_align_repairs_oov_and_short_notes():
    """LM-generated lyrics can contain characters whose G2P yields
    un-encodable units, and melodies can come up short; align repairs both
    (SP substitution / last-note reuse — the reference's repair-not-fail
    convention, SURVEY §5) instead of raising inside the request handler."""
    from music_generation_tpu_torch.frontend.align import ScoreFrontend

    f = ScoreFrontend()
    s = f.align("abc你好", ["C4", "D4"], [0.3, 0.4])  # latin + short melody
    assert len(s.phone_ids) == len(s.shengdiao_ids) == len(s.note_ids)
    assert len(s.phone_ids) > 0
    # the known-good syllables still encode to real phones
    assert any(p != "SP" for p in s.phonemes)
