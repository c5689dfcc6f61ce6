"""The fused song path of the PyTorch port (pipeline/fused.py) against the
JAX package's melody and the port's staged path (CPU, tiny configs).

The JAX FusedSongSynthesizer itself is not built here (its one-program
jit takes most of a minute on the CPU); its contract is held piece by
piece: the notes are the JAX MelodyGenerator.generate_song notes on the
same numpy-seeded weights, token for token, and the per-sentence sample
counts are the staged path's (SongSynthesizer.synthesize_song) on the same
models, so the durations' formatting and the phone-level expansion agree.
"""

import io

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu_torch.frontend import midi_to_note
from music_generation_tpu_torch.pipeline.fused import (FusedSongSynthesizer,
                                                       _midi_table)
from music_generation_tpu_torch.pipeline.synthesis import (
    SongSynthesizer, build_default_song_synthesizer, build_melody_generator,
    build_svs_synthesizers)
from torch_port_util import melody_pair

# three sentences: the fused path pads them to four with ""
SENTENCES = ["小小的天有大大的梦想", "隐形的翅膀", "带我飞过绝望"]
LYRICS = "。".join(SENTENCES)


def _samples(result) -> np.ndarray:
    return wavfile.read(io.BytesIO(result.wav_bytes))[1]


@pytest.fixture(scope="module")
def pipelines():
    jgen, tgen = melody_pair(SENTENCES, audible=True)
    svs = build_svs_synthesizers(tiny=True, n_speakers=1, device="cpu")
    return (jgen, SongSynthesizer(tgen, svs),
            FusedSongSynthesizer(tgen, svs))


def test_fused_notes_match_jax_and_lengths_match_staged(pipelines):
    jgen, staged, fused = pipelines
    want = [[midi_to_note(int(m)) if m != "rest" else "rest" for m in notes]
            for _, notes, _ in jgen.generate_song(SENTENCES)]
    got = fused.synthesize_song(LYRICS)
    assert got.lyrics_sentences == SENTENCES
    assert got.notes == want
    ref = staged.synthesize_song(LYRICS)
    assert ref.notes == want
    assert got.sentence_samples == ref.sentence_samples
    assert len(_samples(got)) == len(_samples(ref)) == \
        4410 + sum(ref.sentence_samples)
    wav = _samples(got)
    assert wav.dtype == np.int16 and np.abs(wav[4410:]).max() > 30000


def test_pinned_syllables_scale_the_song(pipelines):
    _, _, fused = pipelines
    short = fused.synthesize_song(SENTENCES[1], pinned_syllable_seconds=0.2)
    long = fused.synthesize_song(SENTENCES[1], pinned_syllable_seconds=0.5)
    assert len(_samples(long)) > 1.5 * len(_samples(short))


def test_no_sentence_is_the_lead_in(pipelines):
    """Lyrics that split into no sentence give the 0.2 s lead-in, as the
    staged path does."""
    _, staged, fused = pipelines
    got, ref = fused.synthesize_song("啊"), staged.synthesize_song("啊")
    assert got.lyrics_sentences == ref.lyrics_sentences == []
    assert len(_samples(got)) == len(_samples(ref)) == 4410


def test_sdp_durations_formatted_as_staged():
    """Under SDP durations (svs_v5) the fused formatting (the 0.3201 and
    0.4305 clamps on 4-decimal seconds) expands the same frames as the
    staged one, for the same flow noise."""
    melody = build_melody_generator(tiny=True, device="cpu",
                                    duration_variant="sdp")
    svs = build_svs_synthesizers(tiny=True, n_speakers=1, device="cpu")
    staged = SongSynthesizer(melody, svs)
    fused = FusedSongSynthesizer(melody, svs)
    results = []
    for path in (staged, fused):
        melody.generator.manual_seed(7)
        results.append(path.synthesize_song("你好世界。隐形的翅膀"))
    assert results[0].sentence_samples == results[1].sentence_samples


def test_midi_table_and_build_default_fused():
    songs = build_default_song_synthesizer(tiny=True, n_speakers=1,
                                           device="cpu", fused=True)
    assert isinstance(songs, FusedSongSynthesizer)
    table = _midi_table(songs.melody.note_dict)
    tokens = songs.melody.note_dict.tokens
    assert table[:4].tolist() == [0, 0, 0, 0]       # PAD, UNK, BOS, EOS
    assert all(table[i] > 0 for i, tok in enumerate(tokens) if tok.isdigit())


def test_batch_cost_analysis_counts_flops(pipelines):
    _, staged, _ = pipelines
    svs = staged.synthesizers[0]
    score = svs.frontend.align("你好世界AP", ["C4"] * 5, [0.4] * 5)
    state = svs.generator.get_state()
    one = svs.batch_cost_analysis([score])["flops"]
    two = svs.batch_cost_analysis([score] * 2)["flops"]
    assert 0 < one < two
    assert torch.equal(svs.generator.get_state(), state)
