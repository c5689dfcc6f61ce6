"""Spectrograms and training losses of the port vs their jnp twins (CPU).

Seeded numpy inputs through music_generation_tpu.audio.stft /
train.losses and music_generation_tpu_torch.audio.stft / train.losses.
Tolerance: relative error within 1e-5 (float32 sums and FFTs taken in
another order); the mel filterbank, numpy on both sides, is identical.
No segment is exactly silent (energy_loss has a NaN gradient there, in the
JAX package as in the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.audio import stft as j_stft
from music_generation_tpu.core.masking import feature_mask
from music_generation_tpu.train import losses as jl
from music_generation_tpu_torch.audio import stft as t_stft
from music_generation_tpu_torch.train import losses as tl
from torch_port_util import rel_err, t

TOL = 1e-5
B, T, C = 2, 12, 6


def _rng(seed):
    return np.random.RandomState(seed)


def _audio(n, seed):
    return _rng(seed).uniform(-0.5, 0.5, (B, n)).astype(np.float32)


def _stats(seed):
    rng = _rng(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    # log-scales reaching past +-LOGS_CLAMP, so the clamp is exercised
    return (f(B, T, C), 4.0 * f(B, T, C), f(B, T, C), 4.0 * f(B, T, C),
            np.asarray(feature_mask(jnp.asarray([T, 7]), T)))


def _fmaps(seed):
    rng = _rng(seed)
    shapes = ((B, 9, 4), (B, 3, 5))
    return [[rng.randn(*s).astype(np.float32) for s in shapes]
            for _ in range(3)]


def _case(name):
    """(jax value, port value) of one function on seeded inputs."""
    if name == "mel_filterbank":
        return j_stft.mel_filterbank(), t_stft.mel_filterbank()
    if name.startswith("spectrogram"):
        n_fft, hop, n = {"spectrogram": (1024, 256, 4096),
                         "spectrogram_tiny": (128, 16, 512),
                         "spectrogram_short": (1024, 16, 128)}[name]
        y = _audio(n, 1)
        return (j_stft.spectrogram(jnp.asarray(y), n_fft, hop, n_fft),
                t_stft.spectrogram(t(y), n_fft, hop, n_fft))
    if name == "mel_spectrogram":
        y = _audio(4096, 2)
        return (j_stft.mel_spectrogram(jnp.asarray(y)),
                t_stft.mel_spectrogram(t(y)))
    if name == "spec_to_mel":
        spec = np.abs(_rng(3).randn(B, 7, 513)).astype(np.float32)
        return j_stft.spec_to_mel(jnp.asarray(spec)), t_stft.spec_to_mel(
            t(spec))
    if name in ("kl_divergence", "gaussian_nll"):
        z, logs_q, m, logs_p, mask = _stats(4)
        if name == "kl_divergence":
            args = (z, logs_q, m, logs_p, mask)
        else:
            args = (z, m, logs_p, mask)
    elif name == "duration_loss":
        rng = _rng(5)
        mask = np.asarray(feature_mask(jnp.asarray([T, 7]), T))[..., 0]
        args = (rng.uniform(0, 1, (B, T)).astype(np.float32),
                rng.uniform(0.1, 0.5, (B, T)).astype(np.float32),
                rng.randint(0, 30, (B, T)).astype(np.int32), 0.0116, mask)
    elif name == "f0_loss":
        rng = _rng(6)
        args = (rng.randn(B, T).astype(np.float32),
                rng.randn(B, T).astype(np.float32),
                np.asarray(feature_mask(jnp.asarray([9, T]), T))[..., 0])
    elif name.startswith("l1_masked"):
        rng = _rng(7)
        a, b = rng.randn(B, T, C).astype(np.float32), rng.randn(
            B, T, C).astype(np.float32)
        mask = np.asarray(feature_mask(jnp.asarray([T, 4]), T))
        args = (a, b, mask) if name == "l1_masked" else (a, b)
        name = "l1_masked"
    elif name.startswith("multires_stft_loss"):
        n = 2048 if name == "multires_stft_loss" else 128
        args = (_audio(n, 8), _audio(n, 9))
        name = "multires_stft_loss"
    elif name == "energy_loss":
        args = (0.3 * _audio(128, 10), _audio(128, 11))
    elif name == "feature_matching_loss":
        args = (_fmaps(12), _fmaps(13))
    elif name == "generator_adv_loss":
        args = ([_rng(14).randn(B, s).astype(np.float32) for s in (3, 8)],)
    elif name == "discriminator_adv_loss":
        args = ([_rng(15).randn(B, s).astype(np.float32) for s in (3, 8)],
                [_rng(16).randn(B, s).astype(np.float32) for s in (3, 8)])

    def conv(a, fn):
        if isinstance(a, list):
            return [conv(x, fn) for x in a]
        return fn(a) if isinstance(a, np.ndarray) else a
    return (getattr(jl, name)(*[conv(a, jnp.asarray) for a in args]),
            getattr(tl, name)(*[conv(a, t) for a in args]))


CASES = ["mel_filterbank", "spectrogram", "spectrogram_tiny",
         "spectrogram_short", "mel_spectrogram", "spec_to_mel",
         "kl_divergence", "gaussian_nll", "duration_loss", "f0_loss",
         "l1_masked", "l1_masked_unmasked", "multires_stft_loss",
         "multires_stft_loss_short", "energy_loss", "feature_matching_loss",
         "generator_adv_loss", "discriminator_adv_loss"]


@pytest.mark.parametrize("name", CASES)
def test_matches_jax(name):
    want, got = _case(name)
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if name == "mel_filterbank":
        np.testing.assert_array_equal(got, want)
    else:
        assert rel_err(got, want) <= TOL, rel_err(got, want)


def test_logs_clamp():
    assert tl.LOGS_CLAMP == jl.LOGS_CLAMP == 7.0


def test_reflect_pad_past_the_signal_matches_jnp_pad():
    """The tiny config's 128-sample segments under the 1024-point mel
    STFT pad by 504 on each side: jnp.pad reflects repeatedly."""
    for n, pad in ((2, 5), (5, 1), (5, 13), (128, 504)):
        x = np.arange(n, dtype=np.float32)[None]
        np.testing.assert_array_equal(
            t_stft.reflect_pad(t(x), pad).numpy(),
            np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (pad, pad)),
                               mode="reflect")))
