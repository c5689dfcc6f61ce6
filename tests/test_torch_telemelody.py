"""TeleMelody, its sampled decode, the MIDI and accompaniment of the
v1_model variant: the PyTorch port vs the JAX package (CPU, tiny configs).

- the lyric stream, the three vocabularies, adapt and adapt_e on
  numpy-seeded patterns: equal;
- both twins' teacher-forced log-probs on numpy-seeded weights carried by
  compat.telemelody_state_dicts_from_flax: within 1e-5 (the melody tests'
  tolerance);
- sample_decode token for token against the JAX package's on JAX's own
  Gumbel draws (each step's key split as jax.random.categorical takes it);
- generate_melody on the same sampled token streams (both sides' _sample
  replaced): notes, lyrics, durations, pitches and MIDI bytes equal;
- render_notes / render_tracks and mix: equal samples;
- SongSynthesizer's accompaniment mix against the JAX package's
  _mix_accompaniment on the same vocal and tracks: equal;
- the v1_model variant built by serve.app: a mixed song of the vocal's
  length.
"""

import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.audio import midi as j_midi
from music_generation_tpu.audio import render as j_render
from music_generation_tpu.audio import wav as j_wav
from music_generation_tpu.models.melody import beam as j_beam
from music_generation_tpu.models.melody import telemelody as j_tm
from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.pipeline import synthesis as j_syn
from music_generation_tpu_torch.audio import midi as t_midi
from music_generation_tpu_torch.audio import render as t_render
from music_generation_tpu_torch.audio import wav as t_wav
from music_generation_tpu_torch.compat import telemelody_state_dicts_from_flax
from music_generation_tpu_torch.models.melody import beam as t_beam
from music_generation_tpu_torch.models.melody import telemelody as t_tm
from music_generation_tpu_torch.models.melody import transformer as t_tr
from music_generation_tpu_torch.pipeline import synthesis as t_syn
from music_generation_tpu_torch.serve import app as t_app
from torch_port_util import _shapes_only_init, random_params, same_config, t

LOGP_TOL = 1e-5
JTINY = j_tr.MelodyConfig(n_layers=1, d_model=32, d_ff=64, n_heads=2,
                          dropout=0.0)
LYRICS = ["明月几时有，把酒问青天。", "你好世界", "小小的天，有大大的梦想！我"]


@pytest.fixture(scope="module")
def twins():
    """(JAX TeleMelodyGenerator, port TeleMelodyGenerator) with the same
    numpy-seeded weights in both twins."""
    with _shapes_only_init(j_tr.MelodyTransformer):
        jgen = j_tm.TeleMelodyGenerator(cfg=JTINY, seed=0)
    jgen.l2r_params = random_params(jgen.l2r_params, 1)
    jgen.t2m_params = random_params(jgen.t2m_params, 2)
    tgen = t_tm.TeleMelodyGenerator(same_config(t_tr.MelodyConfig, JTINY),
                                    device="cpu")
    l2r, t2m = telemelody_state_dicts_from_flax(
        jgen.l2r_params, jgen.t2m_params, tgen.l2r_cfg, tgen.t2m_cfg)
    tgen.lyric2rhythm.load_state_dict(l2r)
    tgen.trend2melody.load_state_dict(t2m)
    return jgen, tgen


def test_lyric_stream_vocabularies_and_regularisers():
    for lyric in LYRICS + ["", "，，啊", "a.b!c"]:
        assert t_tm.process_lyrics(lyric) == j_tm.process_lyrics(lyric)
    for name in ("rhythm_vocab", "trend_vocab", "notes_vocab"):
        assert getattr(t_tm, name)().tokens == getattr(j_tm, name)().tokens
    rng = np.random.RandomState(0)
    for _ in range(40):
        pattern = [[list(rng.randint(0, 4, rng.randint(1, 7)))
                    for _ in range(rng.randint(1, 4))]
                   for _ in range(rng.randint(1, 4))]
        copy = [[list(map(int, s)) for s in sent] for sent in pattern]
        assert t_tm.adapt(copy) == j_tm.adapt(
            [[list(map(int, s)) for s in sent] for sent in pattern])
        n = rng.randint(1, 12)
        e = [(int(rng.randint(0, 4)), int(rng.randint(0, 16)), 0,
              int(rng.randint(40, 96)), int(rng.randint(1, 17)), 31, 0, 0)
             for _ in range(n)]
        e.sort()
        align = sorted(set(rng.randint(0, n, rng.randint(1, n + 1))))
        assert t_tm.adapt_e(e, align) == j_tm.adapt_e(e, align)


@pytest.mark.parametrize("twin", ["lyric2rhythm", "trend2melody"])
def test_twin_logprobs_match_flax(twin, twins):
    jgen, tgen = twins
    params = jgen.l2r_params if twin == "lyric2rhythm" else jgen.t2m_params
    model = getattr(tgen, twin)
    rng = np.random.RandomState(3)
    src = rng.randint(4, model.cfg.src_vocab, (2, 11)).astype(np.int32)
    src[1, 7:] = 0
    tgt = rng.randint(4, model.cfg.tgt_vocab, (2, 9)).astype(np.int32)
    src_mask = (src != 0)[:, None, None, :].astype(np.int32)
    want = jax.jit(getattr(jgen, twin).apply)(params, src, tgt, src_mask,
                                              j_tr.causal_mask(9))
    with torch.no_grad():
        got = model(t(src).long(), t(tgt).long(), t(src_mask),
                    t_tr.causal_mask(9))
    assert got.shape == (2, 9, model.cfg.tgt_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGP_TOL,
                               rtol=0)


def _jax_gumbel(key, max_len, top_k):
    """The Gumbel draws JAX's sample_decode adds at each step: its key is
    split once per step and categorical(sub, vals) is argmax(vals +
    gumbel(sub, vals.shape))."""
    out = []
    for _ in range(max_len):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (top_k,))))
    return np.stack(out)


def _eos_heavy(step_of_eos):
    """A log-prob table that favours EOS from step ``step_of_eos`` on."""
    rng = np.random.RandomState(step_of_eos)
    table = np.log(rng.dirichlet(np.ones(12), 16)).astype(np.float32)
    table[step_of_eos:, 3] += 4.0
    return table


@pytest.mark.parametrize("case", ["lyric2rhythm", "trend2melody", "eos"])
def test_sample_decode_matches_jax(case, twins):
    """Top-k, temperature, EOS forbidden before min_len, PAD after EOS:
    the port's tokens equal the JAX package's, step by step, when both
    take JAX's draws."""
    jgen, tgen = twins
    key = jax.random.PRNGKey(7)
    if case == "eos":
        table = _eos_heavy(2)
        max_len, top_k, temp, min_len = 12, 4, 0.5, 5

        def j_logits(tokens, step):
            return jnp.asarray(table)[step][None]

        def t_logits(tokens, step):
            return t(table[step])[None]
    else:
        params = jgen.l2r_params if case == "lyric2rhythm" else \
            jgen.t2m_params
        jm, tm = getattr(jgen, case), getattr(tgen, case)
        src_ids = list(np.random.RandomState(5).randint(
            4, tm.cfg.src_vocab, 9))
        top_k = 2 if case == "lyric2rhythm" else 10
        max_len, temp, min_len = 14, 0.5, 4
        src = np.asarray([src_ids + [j_tm.EOS_ID]], np.int32)
        src_attn = (src != 0)[:, None, None, :].astype(np.int32)
        memory = jm.apply(params, src, src_attn,
                          method=j_tr.MelodyTransformer.encode)
        mask = j_tr.causal_mask(max_len + 1)

        def j_logits(tokens, step):
            out = jm.apply(params, memory, src_attn, tokens, mask,
                           method=j_tr.MelodyTransformer.decode)
            return jm.apply(params, out[:, step],
                            method=j_tr.MelodyTransformer.logits)
        with torch.no_grad():
            t_src = t(src).long()
            t_attn = (t_src != 0)[:, None, None, :].to(torch.int32)
            t_mem = tm.encode(t_src, t_attn)
        t_mask = t_tr.causal_mask(max_len + 1)

        def t_logits(tokens, step):
            with torch.no_grad():
                out = tm.decode(t_mem, t_attn, tokens, t_mask)
                return tm.logits(out[:, step])
    want = np.asarray(jax.jit(lambda k: j_beam.sample_decode(
        j_logits, k, max_len, j_tm.BOS_ID, j_tm.EOS_ID, top_k=top_k,
        temperature=temp, min_len=min_len))(key))
    got = t_beam.sample_decode(
        t_logits, max_len, t_tm.BOS_ID, t_tm.EOS_ID, top_k=top_k,
        temperature=temp, min_len=min_len,
        noise=t(_jax_gumbel(key, max_len, top_k))).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "eos":
        eos = list(got).index(t_tm.EOS_ID)
        assert eos >= min_len and not got[eos + 1:].any()


def test_sample_decode_draws_from_generator():
    """Without injected noise the draws come from the generator: the same
    seed gives the same tokens, and every token is one of each step's top
    k."""
    table = _eos_heavy(30)

    def logits(tokens, step):
        return t(table[step % 16])[None]

    def run(seed):
        return t_beam.sample_decode(
            logits, 20, 2, 3, top_k=3, temperature=0.5,
            generator=torch.Generator().manual_seed(seed)).tolist()
    assert run(1) == run(1)
    for step, tok in enumerate(run(2)):
        assert tok in np.argsort(-table[step % 16], kind="stable")[:3]


def _streams(seed, n_words):
    """Sampled-looking token streams: a rhythm stream over the rhythm
    vocabulary, then a REMI stream of Bar/Pos/Pitch/Dur groups with stray
    tokens between them."""
    rng = np.random.RandomState(seed)
    notes = t_tm.notes_vocab()
    rhythm = list(rng.randint(4, 10, n_words + rng.randint(-2, 3)))
    remi, bar = [], 0
    for _ in range(n_words + rng.randint(-3, 2)):
        bar += rng.randint(0, 2)
        group = [f"Bar_{bar}", f"Pos_{rng.randint(0, 16)}",
                 f"Pitch_{rng.randint(40, 96)}", f"Dur_{rng.randint(1, 17)}"]
        if rng.rand() < 0.3:
            group.insert(rng.randint(0, 4), f"Pitch_{rng.randint(40, 96)}")
        remi += notes.encode(group)
    return [[int(x) for x in rhythm], remi]


@pytest.mark.parametrize("seed", range(4))
def test_generate_melody_matches_jax_on_same_streams(seed, twins):
    """The REMI post-processing, chord lattice, tracks, lyric events,
    durations and pitches of generate_melody, and the MIDI bytes of its
    tracks, equal the JAX package's when both sides take the same sampled
    token streams (seed 3: an empty note stream, the degenerate
    fallback)."""
    jgen, tgen = twins
    lyric = LYRICS[seed % len(LYRICS)]
    streams = _streams(seed, len(lyric))
    if seed == 3:
        streams[1] = []

    def feeder():
        queue = [list(s) for s in streams]
        return lambda *args, **kwargs: queue.pop(0)
    with mock.patch.object(jgen, "_sample", feeder()):
        want, w_dur, w_pitch = jgen.get_melody(lyric)
    with mock.patch.object(tgen, "_sample", feeder()):
        got, g_dur, g_pitch = tgen.get_melody(lyric)
    assert g_dur == w_dur and g_pitch == w_pitch
    for g, w in ((got.melody, want.melody), (got.chords, want.chords)):
        assert [tuple(vars(n).values()) for n in g.notes] == \
            [tuple(vars(n).values()) for n in w.notes]
        assert g.lyrics == w.lyrics and g.program == w.program
    assert t_midi.write_midi_bytes(got.tracks, tempo_bpm=80) == \
        j_midi.write_midi_bytes(want.tracks, tempo_bpm=80)
    assert t_midi.seconds_to_ticks(1.37) == j_midi.seconds_to_ticks(1.37)


def _tracks(seed, twins, lyric=LYRICS[1]):
    """The port's tracks of ``lyric`` on _streams(seed), and a copy of
    them as the JAX package's Track/Note objects."""
    tgen = twins[1]
    queue = [list(s) for s in _streams(seed, len(lyric))]
    with mock.patch.object(tgen, "_sample",
                           lambda *a, **k: queue.pop(0)):
        result = tgen.generate_melody(t_tm.process_lyrics(lyric))
    to_j = [j_midi.Track(tr.name, tr.program, tr.channel,
                         [j_midi.Note(n.pitch, n.start, n.end, n.velocity)
                          for n in tr.notes], list(tr.lyrics))
            for tr in result.tracks]
    return result.tracks, to_j


def test_render_and_mix_match_jax(twins):
    """render_tracks at the tempo clock and at the vocal's (sec_per_tick
    0.001, a fixed length), and mix: equal samples."""
    tracks, j_tracks = _tracks(0, twins)
    for kw in ({"tempo_bpm": 80, "tick_offset": 240},
               {"sec_per_tick": 0.001, "total_seconds": 3.1, "gain": 1.0}):
        got = t_render.render_tracks(tracks, **kw)
        want = j_render.render_tracks(j_tracks, **kw)
        assert got.dtype == want.dtype == np.float32 and len(got) > 0
        np.testing.assert_array_equal(got, want)
    assert len(t_render.render_tracks([t_midi.Track()],
                                      total_seconds=0.5)) == 11025
    rng = np.random.RandomState(1)
    accomp, vocal = rng.randn(900) * 9000, rng.randn(700) * 20000
    np.testing.assert_array_equal(t_wav.mix(accomp, vocal),
                                  j_wav.mix(accomp, vocal))
    np.testing.assert_array_equal(t_wav.resample(vocal, 44100, 22050),
                                  j_wav.resample(vocal, 44100, 22050))


def test_song_mix_matches_jax(twins):
    """SongSynthesizer._mix_accompaniment: each sentence's tracks at its
    offset after the 0.2 s lead-in, on the vocal's clock, scaled to a
    32767 peak, mixed at 0.8: equal to the JAX package's on the same vocal
    and tracks (a sentence without tracks in between)."""
    rng = np.random.RandomState(2)
    wavs = [(rng.randn(n) * 8000).astype(np.int16)
            for n in (30000, 12000, 26000)]
    song = j_wav.concat_with_delay(wavs, delay_seconds=0.2)
    (t0, j0), (t1, j1) = _tracks(1, twins), _tracks(2, twins)
    got = t_syn.SongSynthesizer._mix_accompaniment(
        mock.Mock(accompaniment_gain=0.8), song, wavs, [t0, None, t1])
    want = j_syn.SongSynthesizer._mix_accompaniment(
        mock.Mock(accompaniment_gain=0.8), song, wavs, [j0, None, j1])
    assert len(got) == len(song)
    np.testing.assert_array_equal(got, want)


def test_v1_model_song_is_mixed():
    """serve.app's construction of --variant v1_model (tiny, CPU): the
    TeleMelody adapter keeps each sentence's tracks; the song mixes the
    rendered accompaniment under the vocal: the same length as the vocal
    alone, other samples."""
    args, cfg = t_app.configure(["--variant", "v1_model", "--tiny",
                                 "--device", "cpu"])
    cfg.n_speakers = 1
    songs = t_app.build_songs(args, cfg)
    assert songs.mix_accompaniment and not hasattr(songs.melody,
                                                   "song_tensors")
    text = "你好。小天"
    state = songs.synthesizers[0].generator.get_state()
    mel = songs.melody.gen.generator.get_state()
    mixed = songs.synthesize_song(text)
    assert len(songs.melody.last_tracks) == 2
    songs.synthesizers[0].generator.set_state(state)
    songs.melody.gen.generator.set_state(mel)
    songs.mix_accompaniment = False
    plain = songs.synthesize_song(text)
    assert mixed.notes == plain.notes
    assert "accompaniment_s" in mixed.timings
    _, a = wavfile.read(io.BytesIO(mixed.wav_bytes))
    _, v = wavfile.read(io.BytesIO(plain.wav_bytes))
    assert len(a) == len(v) and not np.array_equal(a, v)


@pytest.mark.slow
def test_full_width_twin_logprobs_match_flax():
    """Both MelodyConfig() twins (6 x 512) against flax on numpy-seeded
    weights: teacher-forced log-probs within 1e-5."""
    with _shapes_only_init(j_tr.MelodyTransformer):
        jgen = j_tm.TeleMelodyGenerator(seed=0)
    tgen = t_tm.TeleMelodyGenerator(t_tr.MelodyConfig(), device="cpu")
    params = (random_params(jgen.l2r_params, 3),
              random_params(jgen.t2m_params, 4))
    states = telemelody_state_dicts_from_flax(*params, tgen.l2r_cfg,
                                              tgen.t2m_cfg)
    for name, p, state in zip(("lyric2rhythm", "trend2melody"), params,
                              states):
        model = getattr(tgen, name)
        model.load_state_dict(state)
        cfg = model.cfg
        rng = np.random.RandomState(5)
        src = rng.randint(4, cfg.src_vocab, (2, 20)).astype(np.int32)
        tgt = rng.randint(4, cfg.tgt_vocab, (2, 30)).astype(np.int32)
        src_mask = (src != 0)[:, None, None, :].astype(np.int32)
        want = jax.jit(getattr(jgen, name).apply)(p, src, tgt, src_mask,
                                                  j_tr.causal_mask(30))
        with torch.no_grad():
            got = model(t(src).long(), t(tgt).long(), t(src_mask),
                        t_tr.causal_mask(30))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGP_TOL, rtol=0)
