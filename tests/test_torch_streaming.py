"""The halo-chunked vocoder decode and streaming of the PyTorch port (CPU,
tiny configs).

SVSSynthesizer._chunked_decode against the JAX package's monolithic
VISinger.decode_hidden on the same numpy-seeded weights and hidden state,
with and without the NSF source (the port's excitation of a voiced
log-F0); stream_score against synthesize_score of the same injected prior
noise; stream_song's lead-in and length against synthesize_song.

Tolerances: the chunked decode within CHUNK_REL (1e-5) of the monolithic
decode's peak; a stream within 1 LSB of clip(monolithic * STREAM_GAIN)
truncated to int16, on audio whose peak is at least AUDIBLE_LSB (1000).
The JAX package's own streaming test compares a random-init decoder's
~1e-7 output, which rounds to 0 at STREAM_GAIN; these tests scale the
port decoder's conv_post instead, so the compared samples are audible.
"""

import dataclasses
import functools
import inspect
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu_torch.compat import visinger_state_dict_from_flax
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.models.svs.hifigan import (
    receptive_radius_frames)
from music_generation_tpu_torch.pipeline.synthesis import (
    SVSSynthesizer, tiny_configs)
from torch_port_util import F, init_params, same_config, svs_score, tiny_songs

CHUNK_REL = 1e-5
AUDIBLE_LSB = 1000
TEXT = "你好世界"
NOTES = ["C4", "D4", "E4", "F4"]


def _tiny_cfg(nsf: bool):
    return dataclasses.replace(tiny_configs(100)[1], nsf=nsf)


@functools.lru_cache(maxsize=None)
def _pair(nsf: bool):
    """(port SVSSynthesizer shell, JAX model, its params) with the same
    numpy-seeded weights; the port model decodes in windows."""
    cfg = _tiny_cfg(nsf)
    jcfg = same_config(jv.SVSConfig, cfg)
    jm = jv.VISinger(jcfg)
    params = init_params(jm, 11, **svs_score(), max_frames=F,
                         method=jv.VISinger.infer)
    params["params"]["spec_encoder"] = init_params(
        jv.PosteriorEncoder(jcfg), 12, jnp.zeros((1, 8, cfg.spec_channels)),
        jnp.ones((1, 8, 1)))["params"]
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg))
    svs = SVSSynthesizer(cfg, device="cpu")
    svs.model = port.eval()
    return svs, jm, params


@functools.lru_cache(maxsize=None)
def _inputs(nsf: bool, f: int):
    """A hidden state [2, f, inter] and, under NSF, the port's excitation
    of a voiced log-F0 (rests included), with the JAX monolithic decode of
    both."""
    svs, jm, params = _pair(nsf)
    rng = np.random.RandomState(f)
    hidden = rng.randn(2, f, svs.cfg.inter_channels).astype(np.float32)
    exc = None
    if nsf:
        hz = 180.0 + 60.0 * np.sin(np.arange(f) / 7.0)[None] + \
            20.0 * rng.rand(2, f)
        hz[:, f // 3: f // 3 + 5] = 0.0                      # a rest
        with torch.no_grad():
            exc = svs.model.excitation(
                torch.from_numpy(np.log1p(hz).astype(np.float32))).numpy()
    want = np.asarray(jm.apply(
        params, jnp.asarray(hidden),
        exc=None if exc is None else jnp.asarray(exc),
        method=jv.VISinger.decode_hidden))
    return hidden, exc, want


def test_halo_covers_the_decoders_receptive_field():
    """The default halo (24) covers the full-width HiFi-GAN stack's reach
    (15 frames) and the tiny one's (7); the tests below use halos >= 8."""
    from music_generation_tpu_torch.models.svs import SVSConfig
    for cfg, want in ((SVSConfig(), 15), (_tiny_cfg(False), 7)):
        got = receptive_radius_frames(
            cfg.resblock, cfg.resblock_kernel_sizes,
            cfg.resblock_dilation_sizes, cfg.upsample_rates,
            cfg.upsample_kernel_sizes)
        assert got == want
    halo = inspect.signature(SVSSynthesizer).parameters["decode_chunk_halo"]
    assert halo.default == 24 >= 15


@pytest.mark.parametrize("nsf", [False, True], ids=["plain", "nsf"])
@pytest.mark.parametrize("chunk,halo,f", [
    (32, 8, 128),     # four windows, the last one flush with the end
    (48, 8, 128),     # the last output window moved back to f - chunk
    (20, 12, 128),    # seven windows, the first two clamped to 0
    (112, 8, 128),    # f <= win: one plain decode
])
def test_chunked_decode_matches_jax(nsf, chunk, halo, f):
    svs, _, _ = _pair(nsf)
    hidden, exc, want = _inputs(nsf, f)
    svs.decode_chunk_frames, svs.decode_chunk_halo = chunk, halo
    with torch.no_grad():
        got = svs._chunked_decode(
            torch.from_numpy(hidden),
            None if exc is None else torch.from_numpy(exc)).numpy()
    assert got.shape == want.shape == (2, f * svs.cfg.hop_length, 1)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= CHUNK_REL * peak


def test_chunked_decode_without_halo_differs():
    """The comparison has teeth: windows with no halo see zero padding at
    their seams and leave the monolithic decode."""
    svs, _, _ = _pair(False)
    hidden, _, want = _inputs(False, 128)
    svs.decode_chunk_frames, svs.decode_chunk_halo = 32, 0
    with torch.no_grad():
        got = svs._chunked_decode(torch.from_numpy(hidden)).numpy()
    assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _audible_svs(nsf: bool) -> SVSSynthesizer:
    """A tiny port synthesizer whose conv_post is scaled 30x so that its
    output is audible at STREAM_GAIN (a random-init decoder's is some 1e-3
    of full scale). Under NSF the F0 comes from the score, which voices
    the source at random init."""
    cfg = dataclasses.replace(_tiny_cfg(nsf),
                              f0_mode="score" if nsf else "predict")
    svs = SVSSynthesizer(cfg, seed=3, device="cpu")
    with torch.no_grad():
        svs.model.decoder.conv_post.weight.mul_(30.0)
    return svs


@pytest.mark.parametrize("nsf", [False, True], ids=["plain", "nsf_score"])
def test_stream_score_matches_monolithic(nsf):
    """The concatenated stream is the monolithic decode of the same prior
    noise at STREAM_GAIN, within 1 LSB, in more than one chunk, and
    audible."""
    svs = _audible_svs(nsf)
    score = svs.frontend.align(TEXT, NOTES, [0.3] * 4)
    max_frames = svs._batch_inputs([score])[0]
    noise = torch.randn((1, max_frames, svs.cfg.inter_channels),
                        generator=torch.Generator().manual_seed(5))
    chunks = list(svs.stream_score(score, chunk_frames=16, noise=noise))
    ref = svs.synthesize_score(score, noise=noise)
    assert len(chunks) > 1
    assert all(c.dtype == np.int16 for c in chunks)
    streamed = np.concatenate(chunks)
    assert len(streamed) == len(ref)
    want = np.clip(ref * svs.STREAM_GAIN, -32768, 32767).astype(np.int16)
    assert np.abs(want.astype(np.int32)).max() >= AUDIBLE_LSB
    assert np.abs(streamed.astype(np.int32) - want).max() <= 1


def test_noise_refused_for_a_score_that_splits():
    svs = _audible_svs(False)
    long = svs.frontend.align("你好世界" * 30, ["C4"] * 120, [0.4] * 120)
    assert len(svs.split_oversize(long)) > 1
    with pytest.raises(ValueError, match="splits into"):
        svs.synthesize_score(long, noise=torch.zeros(1, 1984, 16))


def test_stream_song_lead_in_and_length():
    """stream_song: the 0.2 s silent lead-in first, then as many samples
    as synthesize_song's WAV (the MSE melody is deterministic, so both
    paths expand the same frames)."""
    songs = tiny_songs()
    text = "你好世界。小小的天有大大的梦想"
    chunks = list(songs.stream_song(text))
    lead = int(0.2 * 22050)
    assert len(chunks[0]) == lead and not chunks[0].any()
    assert len(chunks) > 2
    _, wav = wavfile.read(io.BytesIO(songs.synthesize_song(text).wav_bytes))
    assert sum(len(c) for c in chunks) == len(wav)


def test_batch_svs_false_is_per_sentence():
    """synthesize_song(batch_svs=False) decodes each sentence alone and
    peak-normalises it on the host: the same sample counts as the batch."""
    songs = tiny_songs()
    text = "你好世界。小小的天有大大的梦想"
    a = songs.synthesize_song(text)
    b = songs.synthesize_song(text, batch_svs=False)
    wa = wavfile.read(io.BytesIO(a.wav_bytes))[1]
    wb = wavfile.read(io.BytesIO(b.wav_bytes))[1]
    assert len(wa) == len(wb) and a.notes == b.notes
    assert np.abs(wb.astype(np.int32)).max() >= 32766
