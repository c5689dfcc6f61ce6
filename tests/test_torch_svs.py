"""VISinger inference of the PyTorch port vs the JAX package (CPU, tiny).

The tiny SVS config of build_default_song_synthesizer(tiny=True), numpy-
seeded unit-scale parameters (the zero-init flow projections and the
1e-4-scale HiFi-GAN output conv get random values too), the same injected
prior noise. Tolerances: the duration fraction within 1e-5 and the
waveform within 1e-4 relative L2 error. Frame counts are floor(frac * dur /
frame_seconds), so the seed is checked to keep that quotient at least 1e-3
away from an integer, where an ulp could flip it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.core.masking import feature_mask
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu_torch.models.svs import visinger as tv
from torch_port_util import B, F, T, X_LEN, rel_err, t, visinger_pair
from torch_port_util import svs_score as _score


@pytest.fixture(scope="module")
def pair():
    return visinger_pair()


def _jax_infer(jm, params, score, noise, ph_dur=None):
    fn = jax.jit(lambda p, s, n, d: jm.apply(
        p, **s, max_frames=F, noise=n, ph_dur=d, method=jv.VISinger.infer))
    audio, mel_len, aux = fn(params, score, noise, ph_dur)
    return np.asarray(audio), np.asarray(mel_len), aux


def _port_infer(port, score, noise, ph_dur=None):
    with torch.no_grad():
        audio, mel_len, aux = port.infer(
            t(score["phones"]), t(score["x_lengths"]), t(score["note_ids"]),
            t(score["note_durations"]), t(score["shengdiao"]), F,
            noise=t(noise), ph_dur=None if ph_dur is None else t(ph_dur))
    return audio.numpy(), mel_len.numpy(), aux


def _valid(audio, mel_len, hop=256):
    return np.concatenate([audio[i, : int(n) * hop, 0]
                           for i, n in enumerate(mel_len)])


def test_infer_predicted_durations(pair):
    jm, params, port = pair
    score = _score()
    noise = np.random.RandomState(1).randn(B, F, 16).astype(np.float32)
    frac_j = np.asarray(jax.jit(lambda p: jm.apply(
        p, method=lambda m: m.duration_predictor(
            m.text_encoder(score["phones"], score["note_ids"],
                           score["note_durations"], score["shengdiao"],
                           feature_mask(X_LEN, T)),
            feature_mask(X_LEN, T))))(params))
    got_a, got_len, aux = _port_infer(port, score, noise)
    frac_t = aux["frac"].numpy()
    np.testing.assert_allclose(frac_t, frac_j, atol=1e-5, rtol=0)

    quot = (frac_j * score["note_durations"] / port.cfg.frame_seconds)
    quot = quot[np.arange(T)[None, :] < X_LEN[:, None]]
    assert np.min(np.abs(quot - np.round(quot))) >= 1e-3, \
        "seed puts a frame count within 1e-3 of an integer"

    want_a, want_len, want_aux = _jax_infer(jm, params, score, noise)
    np.testing.assert_array_equal(aux["frames"].numpy(),
                                  np.asarray(want_aux["frames"]))
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_allclose(aux["log_f0"].numpy(),
                               np.asarray(want_aux["log_f0"]), atol=1e-4,
                               rtol=1e-5)
    assert rel_err(_valid(got_a, got_len), _valid(want_a, want_len)) <= 1e-4


def test_infer_pinned_durations(pair):
    jm, params, port = pair
    score = _score(3)
    rng = np.random.RandomState(4)
    ph_dur = rng.randint(1, 9, (B, T)).astype(np.int32)
    noise = rng.randn(B, F, 16).astype(np.float32)
    want_a, want_len, _ = _jax_infer(jm, params, score, noise, ph_dur)
    got_a, got_len, _ = _port_infer(port, score, noise, ph_dur)
    np.testing.assert_array_equal(got_len, want_len)
    assert got_a.shape == want_a.shape == (B, F * 256, 1)
    assert rel_err(_valid(got_a, got_len), _valid(want_a, want_len)) <= 1e-4


def test_f0_to_coarse_matches():
    f0 = np.concatenate([[0.0, 30.0, 50.0, 1100.0, 3000.0],
                         np.random.RandomState(2).uniform(40, 1200, 200)])
    f0 = f0.astype(np.float32)
    np.testing.assert_array_equal(
        tv.f0_to_coarse(t(f0)).numpy(),
        np.asarray(jv.f0_to_coarse(jnp.asarray(f0))))
