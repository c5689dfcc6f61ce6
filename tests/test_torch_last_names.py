"""The JAX package's last public names in the PyTorch port, against their
JAX twins (CPU, tiny widths, numpy-seeded inputs and weights carried by
compat.from_jax.state_dict_from_flax; the JAX side runs op by op).

Tolerances: 1e-5 relative for the convolution stacks (float32 sums in
another order); exact for generate_path, frame_signal, hop_seconds and the
MAS duration targets. gated_activation is held within 2e-7: XLA's float32
tanh and sigmoid are approximations of their own, one or two ulps from
torch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.audio import stft as j_stft
from music_generation_tpu.core import layers as j_layers
from music_generation_tpu.core import masking as j_masking
from music_generation_tpu.core import splines as j_splines
from music_generation_tpu.core import wavenet as j_wavenet
from music_generation_tpu.models import duration as j_duration
from music_generation_tpu.models.melody import seq2seq as j_s2s
from music_generation_tpu.models.svs import visinger as j_visinger
from music_generation_tpu.train import losses as j_losses
from music_generation_tpu_torch.audio import stft as t_stft
from music_generation_tpu_torch.compat import (seq2seq_state_dict_from_flax,
                                               state_dict_from_flax)
from music_generation_tpu_torch.core import (
    ConvReluNorm, generate_path, piecewise_rational_quadratic_transform)
from music_generation_tpu_torch.core.layers import FFN, Conv1d, causal_pad
from music_generation_tpu_torch.core.wavenet import gated_activation
from music_generation_tpu_torch.models.duration import LogDurationPredictor
from music_generation_tpu_torch.models.melody import seq2seq as t_s2s
from music_generation_tpu_torch.models.svs import visinger as t_visinger
from music_generation_tpu_torch.train import losses as t_losses
from torch_port_util import init_params, rel_err, same_config, t

B, T, C = 2, 12, 6
REL = 1e-5


def _inputs(seed=0, channels=C):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, channels).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 9:] = 0
    return x, mask


def _load(port, params):
    port.load_state_dict(state_dict_from_flax(params, port))
    return port.eval()


@pytest.mark.parametrize("kernel_size,dilation", [(3, 1), (4, 2)])
def test_causal_conv1d_matches_jax(kernel_size, dilation):
    x, _ = _inputs()
    jm = j_layers.Conv1d(5, kernel_size, dilation=dilation, causal=True)
    params = init_params(jm, 1, x)
    want = np.asarray(jm.apply(params, x))
    port = _load(Conv1d(C, 5, kernel_size, dilation=dilation, causal=True),
                 params)
    assert causal_pad(kernel_size, dilation) == port.pad
    with torch.no_grad():
        got = port(t(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < REL
    # causal: the output at step i sees no input after i
    x2 = x.copy()
    x2[:, 7:] += 1.0
    with torch.no_grad():
        got2 = port(t(x2).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_array_equal(got2[:, :7], got[:, :7])


@pytest.mark.parametrize("kernel_size", [3, 4])
def test_causal_ffn_matches_jax(kernel_size):
    x, mask = _inputs(2)
    jm = j_layers.FFN(C, 16, kernel_size, causal=True)
    params = init_params(jm, 3, x, mask)
    want = np.asarray(jm.apply(params, x, mask))
    port = _load(FFN(C, C, 16, kernel_size, causal=True), params)
    with torch.no_grad():
        got = port(t(x), t(mask)).numpy()
    assert rel_err(got, want) < REL


@pytest.mark.parametrize("n_layers", [1, 3])
def test_conv_relu_norm_matches_jax(n_layers):
    """Random (not zero) proj weights, so the residual branch shows."""
    x, mask = _inputs(4)
    jm = j_layers.ConvReluNorm(hidden_channels=10, out_channels=C,
                               kernel_size=3, n_layers=n_layers)
    params = init_params(jm, 5, x, mask)
    want = np.asarray(jm.apply(params, x, mask))
    port = _load(ConvReluNorm(C, 10, C, 3, n_layers), params)
    with torch.no_grad():
        got = port(t(x), t(mask)).numpy()
    assert rel_err(got, want) < REL
    fresh = ConvReluNorm(C, 10, C, 3, n_layers)  # zero-init proj: identity
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(t(x), t(mask)).numpy(),
                                      x * mask)


@pytest.mark.parametrize("with_g", [False, True])
def test_log_duration_predictor_matches_jax(with_g):
    x, mask = _inputs(6)
    g = np.random.RandomState(7).randn(B, 1, 4).astype(np.float32) \
        if with_g else None
    jm = j_duration.LogDurationPredictor(filter_channels=8, kernel_size=3,
                                         dropout_rate=0.5,
                                         gin_channels=4 if with_g else 0)
    params = init_params(jm, 8, x, mask, g)
    want = np.asarray(jm.apply(params, x, mask, g))
    port = _load(LogDurationPredictor(C, 8, 3, dropout_rate=0.5,
                                      gin_channels=4 if with_g else 0),
                 params)
    with torch.no_grad():
        got = port(t(x), t(mask), None if g is None else t(g)).numpy()
    assert got.shape == (B, T)
    assert rel_err(got, want) < REL
    assert not got[1, 9:].any()


def test_log_duration_predictor_refuses_unbuilt_cond():
    x, mask = _inputs()
    with pytest.raises(ValueError, match="gin_channels=0"):
        LogDurationPredictor(C, 8, 3)(t(x), t(mask), torch.zeros(B, 1, 4))


def test_generate_path_matches_jax():
    durations = np.array([[2, 0, 3, 1], [1, 4, 0, 0]], np.int32)
    want = np.asarray(j_masking.generate_path(jnp.asarray(durations), 8))
    got = generate_path(t(durations), 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_signal_matches_jax():
    y = np.random.RandomState(9).randn(2, 103).astype(np.float32)
    want = np.asarray(j_stft.frame_signal(jnp.asarray(y), 16, 5))
    got = t_stft.frame_signal(t(y), 16, 5).numpy()
    assert got.shape == want.shape == (2, 18, 16)
    np.testing.assert_array_equal(got, want)


def test_gated_activation_matches_jax():
    rng = np.random.RandomState(10)
    x_in = rng.randn(B, T, 8).astype(np.float32)
    g_l = rng.randn(B, 1, 8).astype(np.float32)
    want = np.asarray(j_wavenet.gated_activation(x_in, g_l, 4))
    got = gated_activation(t(x_in), t(g_l), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    # channels-first, as the WaveNet calls it, and without g_l
    first = gated_activation(t(x_in).transpose(1, 2), None, 4, dim=1)
    np.testing.assert_array_equal(
        first.transpose(1, 2).numpy(),
        gated_activation(t(x_in), None, 4).numpy())


def test_hop_seconds_matches_jax():
    for fields in ({}, {"hop_length": 16, "sampling_rate": 16000}):
        jcfg = j_visinger.SVSConfig(**fields)
        cfg = same_config(t_visinger.SVSConfig, jcfg)
        assert cfg.hop_seconds == jcfg.hop_seconds


@pytest.mark.parametrize("tails,inverse", [(None, False), ("linear", False),
                                           ("linear", True)])
def test_piecewise_spline_transform_matches_jax(tails, inverse):
    rng = np.random.RandomState(11)
    bins = 5
    inputs = (rng.rand(3, 7) if tails is None
              else 4.0 * rng.randn(3, 7)).astype(np.float32)
    widths, heights = (rng.randn(3, 7, bins).astype(np.float32)
                       for _ in range(2))
    derivs = rng.randn(3, 7, bins + (-1 if tails else 1)).astype(np.float32)
    want = j_splines.piecewise_rational_quadratic_transform(
        inputs, widths, heights, derivs, inverse=inverse, tails=tails)
    got = piecewise_rational_quadratic_transform(
        t(inputs), t(widths), t(heights), t(derivs), inverse=inverse,
        tails=tails)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_losses_mas_duration_targets_matches_jax():
    rng = np.random.RandomState(12)
    z_p = rng.randn(2, 20, 4).astype(np.float32)
    m_p = rng.randn(2, 6, 4).astype(np.float32)
    logs_p = 4.0 * rng.randn(2, 6, 4).astype(np.float32)  # past the clamp
    x_mask = np.ones((2, 6, 1), np.float32)
    x_mask[1, 4:] = 0
    y_mask = np.ones((2, 20, 1), np.float32)
    y_mask[1, 15:] = 0
    want = np.asarray(j_losses.mas_duration_targets(z_p, m_p, logs_p, x_mask,
                                                    y_mask))
    got = t_losses.mas_duration_targets(t(z_p), t(m_p), t(logs_p), t(x_mask),
                                        t(y_mask))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lstm", [False, True])
def test_seq2seq_step_methods_match_jax(lstm):
    """encode (no lengths), init_decoder_state and two decode_steps."""
    jcfg = j_s2s.Seq2SeqConfig(en_vocab=30, de_vocab=20, en_embedding_dim=16,
                               de_embedding_dim=16, hidden_dim=16,
                               use_lstm=lstm)
    jm = j_s2s.Seq2SeqModel(jcfg)
    src = np.array([[5, 6, 7, 8, 2], [9, 10, 11, 12, 13]], np.int32)
    params = init_params(jm, 13, src, np.zeros((2, 2), np.int32))
    cfg = same_config(t_s2s.Seq2SeqConfig, jcfg)
    port = t_s2s.Seq2SeqModel(cfg)
    port.load_state_dict(seq2seq_state_dict_from_flax(params, cfg))
    port.eval()
    want_out, want_h = jm.apply(params, src, method=j_s2s.Seq2SeqModel.encode)
    want_state = jm.apply(params, want_h,
                          method=j_s2s.Seq2SeqModel.init_decoder_state)
    with torch.no_grad():
        got_out, got_h = port.encode(t(src).long())
        state = port.init_decoder_state(got_h)
    assert rel_err(got_out.numpy(), want_out) < REL
    assert rel_err(got_h.numpy(), want_h) < REL
    for token in ([3, 3], [4, 7]):
        want_lp, want_state = jm.apply(
            params, np.array(token, np.int32), want_out, want_state,
            method=j_s2s.Seq2SeqModel.decode_step)
        with torch.no_grad():
            got_lp, state = port.decode_step(torch.tensor(token), got_out,
                                             state)
        assert rel_err(got_lp.numpy(), want_lp) < REL
