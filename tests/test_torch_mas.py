"""MAS of the PyTorch port vs the JAX package (CPU).

The plain version maximum_path_torch is held bit for bit against the numpy
oracle and the lax implementation on ragged batches, as
tests/test_monotonic_align.py holds the Pallas kernel; the CUDA kernel is
held against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.core.masking import feature_mask
from music_generation_tpu.ops import (mas_duration_targets as j_targets,
                                      maximum_path_jax, maximum_path_numpy)
from music_generation_tpu_torch.ops import (mas_duration_targets,
                                            maximum_path, maximum_path_torch)
from torch_port_util import t


def _random_case(b=4, t_y=31, t_x=11, seed=0):
    rng = np.random.RandomState(seed)
    neg_cent = rng.randn(b, t_y, t_x).astype(np.float32)
    mask = np.ones((b, t_y, t_x), np.float32)
    for i in range(1, b):
        ty = rng.randint(t_x, t_y + 1)
        tx = rng.randint(2, min(t_x, ty) + 1)
        mask[i, ty:, :] = 0
        mask[i, :, tx:] = 0
    return neg_cent, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_numpy_and_lax(seed):
    neg_cent, mask = _random_case(seed=seed)
    got = maximum_path_torch(t(neg_cent), t(mask)).numpy()
    np.testing.assert_array_equal(got, maximum_path_numpy(neg_cent, mask))
    np.testing.assert_array_equal(
        got, np.asarray(maximum_path_jax(jnp.asarray(neg_cent),
                                         jnp.asarray(mask))))


def test_plain_edge_cases():
    """t_x == t_y (the diagonal only) and an empty item (t_x == 0)."""
    rng = np.random.RandomState(5)
    neg_cent = rng.randn(2, 9, 9).astype(np.float32)
    mask = np.ones((2, 9, 9), np.float32)
    mask[1] = 0
    got = maximum_path_torch(t(neg_cent), t(mask)).numpy()
    np.testing.assert_array_equal(got, maximum_path_numpy(neg_cent, mask))
    np.testing.assert_array_equal(got[0], np.eye(9, dtype=np.float32))
    assert not got[1].any()


def test_cpu_tensor_takes_plain_path_and_counts():
    neg_cent, mask = _random_case(seed=3)
    plain, kernel = maximum_path.plain_calls, maximum_path.kernel_launches
    got = maximum_path(t(neg_cent), t(mask)).numpy()
    assert maximum_path.plain_calls == plain + 1
    assert maximum_path.kernel_launches == kernel
    np.testing.assert_array_equal(got, maximum_path_numpy(neg_cent, mask))


def test_wrapper_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(2, 5, 3), torch.zeros(2, 5, 4))


@pytest.mark.parametrize("mask_device", ["cpu", "meta"])
def test_wrapper_takes_plain_path_only_on_cpu(mask_device):
    """A tensor that is not on the CPU never reaches the plain version:
    only CUDA tensors launch the kernel, anything else raises."""
    plain = maximum_path.plain_calls
    with pytest.raises(ValueError):
        maximum_path(torch.zeros(2, 5, 3, device="meta"),
                     torch.zeros(2, 5, 3, device=mask_device))
    assert maximum_path.plain_calls == plain


def test_duration_targets_match_jax():
    rng = np.random.RandomState(7)
    b, f, tok, c = 3, 40, 9, 6
    z_p = rng.randn(b, f, c).astype(np.float32)
    m_p = rng.randn(b, tok, c).astype(np.float32)
    logs_p = 0.3 * rng.randn(b, tok, c).astype(np.float32)
    x_len, y_len = np.array([9, 6, 4]), np.array([40, 31, 12])
    x_mask = np.asarray(feature_mask(jnp.asarray(x_len), tok))
    y_mask = np.asarray(feature_mask(jnp.asarray(y_len), f))
    want = np.asarray(jax.jit(j_targets)(z_p, m_p, logs_p, x_mask, y_mask))
    got = mas_duration_targets(t(z_p), t(m_p), t(logs_p), t(x_mask),
                               t(y_mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(1), y_len)


def test_phase_cycles_tool_still_instruments_the_kernel():
    """tools/torch_mas_phase_cycles.py edits the kernel source at fixed
    anchors; an edit of the kernel that moves one must fail here, on the
    CPU, and not first on the card."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "tools"
            / "torch_mas_phase_cycles.py")
    spec = importlib.util.spec_from_file_location("mas_phase_cycles", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.instrumented_source()
    assert src.count("clock64()") == 5
    assert "long long* clk" in src and "s, clk);" in src
