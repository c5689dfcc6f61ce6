"""Core layers of the PyTorch port vs their flax twins (CPU, tiny widths).

Same numpy-seeded parameters through compat.from_jax and the same inputs,
ragged masks included; tolerance: relative L2 error <= 1e-5 (float32 sums
taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.core import attention as j_attn
from music_generation_tpu.core import flows as j_flows
from music_generation_tpu.core import layers as j_layers
from music_generation_tpu.core import masking as j_mask
from music_generation_tpu.core import wavenet as j_wn
from music_generation_tpu_torch.compat import state_dict_from_flax
from music_generation_tpu_torch.core import attention as t_attn
from music_generation_tpu_torch.core import flows as t_flows
from music_generation_tpu_torch.core import layers as t_layers
from music_generation_tpu_torch.core import masking as t_mask
from music_generation_tpu_torch.core import wavenet as t_wn
from torch_port_util import init_params, rel_err, t

TOL = 1e-5
B, T, C = 3, 23, 8
LENGTHS = np.array([23, 17, 5], np.int32)


def _inputs(seed=0, channels=C):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, channels).astype(np.float32)
    mask = np.asarray(j_mask.feature_mask(jnp.asarray(LENGTHS), T))
    return x, mask


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params, module))
    return module.eval()


def test_masks_match():
    lengths = jnp.asarray(LENGTHS)
    np.testing.assert_array_equal(
        t_mask.sequence_mask(t(LENGTHS), T).numpy(),
        np.asarray(j_mask.sequence_mask(lengths, T)))
    np.testing.assert_array_equal(
        t_mask.feature_mask(t(LENGTHS), T).numpy(),
        np.asarray(j_mask.feature_mask(lengths, T)))


@pytest.mark.parametrize("t_y", [12, 40])
def test_expand_by_durations_matches(t_y):
    rng = np.random.RandomState(t_y)
    x = rng.randn(B, 7, 4).astype(np.float32)
    dur = rng.randint(0, 5, (B, 7)).astype(np.int32)
    dur[2, 4:] = 0
    want, want_len = j_mask.expand_by_durations(jnp.asarray(x),
                                                jnp.asarray(dur), t_y)
    got, got_len = t_mask.expand_by_durations(t(x), t(dur), t_y)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_slice_segments_matches():
    x, _ = _inputs(1)
    starts = np.array([0, 5, 13], np.int32)
    want = j_mask.slice_segments(jnp.asarray(x), jnp.asarray(starts), 9)
    got = t_mask.slice_segments(t(x), t(starts).long(), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel,dilation,weight_norm",
                         [(1, 1, False), (3, 1, False), (5, 3, True),
                          (4, 2, True)])
def test_conv1d_matches(kernel, dilation, weight_norm):
    x, _ = _inputs(2)
    jm = j_layers.Conv1d(6, kernel, dilation=dilation,
                         weight_norm=weight_norm)
    params = init_params(jm, 3, x)
    want = jax.jit(jm.apply)(params, x)
    tm = _port(t_layers.Conv1d(C, 6, kernel, dilation=dilation,
                               weight_norm=weight_norm), params)
    with torch.no_grad():
        got = t_layers.conv_ntc(tm, t(x))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("kernel,stride", [(16, 8), (4, 2)])
def test_conv_transpose1d_matches(kernel, stride):
    x, _ = _inputs(4)
    jm = j_layers.ConvTranspose1d(5, kernel, stride)
    params = init_params(jm, 5, x)
    want = jax.jit(jm.apply)(params, x)
    tm = _port(t_layers.ConvTranspose1d(C, 5, kernel, stride), params)
    with torch.no_grad():
        got = tm(t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == want.shape == (B, T * stride, 5)
    assert rel_err(got, want) <= TOL


def test_transformer_encoder_ragged_masks():
    x, mask = _inputs(6)
    jm = j_attn.TransformerEncoder(C, 16, 2, 2, 3)
    params = init_params(jm, 7, x, mask)
    want = jax.jit(jm.apply)(params, x, mask)
    tm = _port(t_attn.TransformerEncoder(C, 16, 2, 2, 3), params)
    with torch.no_grad():
        got = tm(t(x), t(mask))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("length", [3, 9])
def test_relative_position_shuffles_match(length):
    rng = np.random.RandomState(length)
    rel = rng.randn(2, 2, length, 2 * length - 1).astype(np.float32)
    ab = rng.randn(2, 2, length, length).astype(np.float32)
    np.testing.assert_array_equal(
        t_attn._relative_to_absolute(t(rel)).numpy(),
        np.asarray(j_attn._relative_to_absolute(jnp.asarray(rel))))
    np.testing.assert_array_equal(
        t_attn._absolute_to_relative(t(ab)).numpy(),
        np.asarray(j_attn._absolute_to_relative(jnp.asarray(ab))))


def test_wavenet_matches():
    x, mask = _inputs(8)
    jm = j_wn.WaveNet(C, 5, 1, 4)
    params = init_params(jm, 9, x, mask)
    want = jax.jit(jm.apply)(params, x, mask)
    tm = _port(t_wn.WaveNet(C, 5, 1, 4), params)
    with torch.no_grad():
        got = tm(t(x), t(mask))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_flow_matches(reverse):
    x, mask = _inputs(10)
    x = x * mask
    jm = j_flows.ResidualCouplingBlock(C, 12, 5, 1, 3)
    params = init_params(jm, 11, x, mask)
    want = jax.jit(jm.apply, static_argnames="reverse")(
        params, x, mask, reverse=reverse)
    tm = _port(t_flows.ResidualCouplingBlock(C, 12, 5, 1, 3), params)
    with torch.no_grad():
        got = tm(t(x), t(mask), reverse=reverse)
        back = tm(got, t(mask), reverse=not reverse)
    assert rel_err(got, want) <= TOL
    # the port's two directions invert each other
    assert rel_err(back, x) <= TOL
