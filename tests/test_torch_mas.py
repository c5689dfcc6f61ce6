"""MAS of the PyTorch port vs the JAX package (CPU).

The plain version maximum_path_torch is held bit for bit against the numpy
oracle and the lax implementation on ragged batches, as
tests/test_monotonic_align.py holds the Pallas kernel; the CUDA kernel is
held against the plain version on the card by chip_smoke.py. mas_plan, the
wrapper's choice of kernel variant with its shared memory and scratch, is
checked here at the limits of each variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.core.masking import feature_mask
from music_generation_tpu.ops import (mas_duration_targets as j_targets,
                                      maximum_path_jax, maximum_path_numpy)
from music_generation_tpu_torch.ops import (mas_duration_targets, mas_plan,
                                            maximum_path, maximum_path_torch)
from music_generation_tpu_torch.ops.monotonic_align import (
    MAX_WARPS, SMEM_BYTES, WIDE_SMEM_BYTES, wide_plan)
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


# at each K of the warp variant: Tx, the largest Ty it takes (4 * Ty *
# (K + 1) bytes of shared memory within 232,448), and the wide variant's K
# and warps one row past it
WARP_LIMITS = {1: (20, 29056, 1, 1), 2: (64, 19370, 1, 2),
               4: (128, 11622, 1, 4), 8: (256, 6456, 1, 8),
               16: (512, 3418, 2, 8), 32: (1024, 1760, 4, 8)}


@pytest.mark.parametrize("k", sorted(WARP_LIMITS))
def test_plan_warp_variant_up_to_its_shared_memory(k):
    t_x, t_y, wide_k, wide_warps = WARP_LIMITS[k]
    plan = mas_plan(t_y, t_x)
    assert (plan.variant, plan.k, plan.warps, plan.strips) == ("warp", k, 1, 1)
    assert plan.smem_bytes == 4 * t_y * (k + 1) <= SMEM_BYTES
    assert plan.scratch_bytes == 0
    # one row more: the wide variant, the bits in the scratch
    plan = mas_plan(t_y + 1, t_x)
    words = -(-t_x // 32)
    assert (plan.variant, plan.k, plan.warps, plan.strips) == (
        "wide", wide_k, wide_warps, 1)
    assert plan.smem_bytes == WIDE_SMEM_BYTES <= SMEM_BYTES
    assert plan.scratch_bytes == 4 * (t_y + 1) * (words + 1)


@pytest.mark.parametrize("t_y,t_x,want", [
    # chip_smoke.py's phase 2b shapes
    (480, 64, ("warp", 2, 1, 1, 5760, 0)),
    (20000, 64, ("wide", 1, 2, 1, WIDE_SMEM_BYTES, 4 * 20000 * 3)),
    (8000, 256, ("wide", 1, 8, 1, WIDE_SMEM_BYTES, 4 * 8000 * 9)),
    (3000, 1500, ("wide", 8, 6, 1, WIDE_SMEM_BYTES, 4 * 3000 * 48)),
    # the warp variant's column limit, and one more
    (1760, 1024, ("warp", 32, 1, 1, 232320, 0)),
    (100, 1025, ("wide", 8, 5, 1, WIDE_SMEM_BYTES, 4 * 100 * 34)),
    # K doubles where 8 warps no longer hold the row
    (100, 2048, ("wide", 8, 8, 1, WIDE_SMEM_BYTES, 4 * 100 * 65)),
    (100, 2049, ("wide", 16, 5, 1, WIDE_SMEM_BYTES, 4 * 100 * 66)),
    # eight warps make one strip of 8192 columns; past it, strips and the
    # two edge columns
    (100, 8192, ("wide", 32, 8, 1, WIDE_SMEM_BYTES, 4 * 100 * 257)),
    (100, 8193, ("wide", 32, 8, 2, WIDE_SMEM_BYTES, 4 * 100 * 260)),
    (20000, 16384, ("wide", 32, 8, 2, WIDE_SMEM_BYTES, 4 * 20000 * 515)),
    (50, 100000, ("wide", 32, 8, 13, WIDE_SMEM_BYTES, 4 * 50 * 3128)),
])
def test_plan_takes_every_shape(t_y, t_x, want):
    plan = mas_plan(t_y, t_x)
    assert (plan.variant, plan.k, plan.warps, plan.strips, plan.smem_bytes,
            plan.scratch_bytes) == want
    assert plan.smem_bytes <= SMEM_BYTES
    assert plan.warps * 32 * plan.k * plan.strips >= t_x


def test_plan_wide_on_request():
    """The wide variant where the warp variant would do (chip_smoke.py and
    tools/torch_mas_timing.py run it alone): wide_plan at its default K is
    the plan mas_plan gives where the warp variant does not fit."""
    plan = wide_plan(480, 64)
    assert (plan.variant, plan.k, plan.warps, plan.strips) == ("wide", 1, 2, 1)
    assert plan.scratch_bytes == 4 * 480 * 3
    for t_y, t_x in [(20000, 64), (3000, 1500), (100, 2049), (50, 100000)]:
        assert wide_plan(t_y, t_x) == mas_plan(t_y, t_x)


def test_wide_smem_matches_the_kernel_source():
    """WIDE_SMEM_BYTES and MAX_WARPS restate csrc/monotonic_align.cu's
    kWideSmem and kMaxWarps; read them from the source."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "music_generation_tpu_torch"
           / "csrc" / "monotonic_align.cu").read_text()
    const = {name: int(value) for name, value in re.findall(
        r"constexpr int (kMaxWarps|kStageRows) = (\d+);", src)}
    assert "constexpr int kStageWords = kStageRows / 32 + 1;" in src
    assert "constexpr int kWideHead = 4 * kMaxWarps + 1;" in src
    assert ("constexpr int kWideSmem = (kWideHead + kStageRows * "
            "kStageWords) * 4;") in src
    rows = const["kStageRows"]
    assert const["kMaxWarps"] == MAX_WARPS
    assert WIDE_SMEM_BYTES == (4 * MAX_WARPS + 1 + rows * (rows // 32 + 1)) * 4


def test_plain_matches_lax_past_the_warp_variant():
    """The plain version, which chip_smoke.py holds the kernel to on the
    card, against the lax implementation at a shape the warp variant
    refuses (Tx > 1024), ragged, with an item of more tokens than frames."""
    b, t_y, t_x = 3, 1200, 1100
    rng = np.random.RandomState(21)
    neg_cent = (10.0 * rng.randn(b, t_y, t_x)).astype(np.float32)
    mask = np.zeros((b, t_y, t_x), np.float32)
    for i, (ty, tx) in enumerate([(1200, 1100), (700, 1100), (1150, 480)]):
        mask[i, :ty, :tx] = 1.0
    assert mas_plan(t_y, t_x).variant == "wide"
    got = maximum_path_torch(t(neg_cent), t(mask)).numpy()
    want = np.asarray(maximum_path_jax(jnp.asarray(neg_cent),
                                       jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(-1), mask[:, :, 0])
