"""Monotonic alignment search (VITS MAS): CUDA kernel + plain PyTorch version.

Twin of music_generation_tpu/ops/monotonic_align.py. ``maximum_path``
launches the hand-written Hopper kernel (csrc/monotonic_align.cu, which
replaces the Pallas kernel ``_mas_kernel``) for CUDA tensors and takes the
plain version ``maximum_path_torch`` only for CPU tensors; it never falls
back from one to the other. MAS is forward-only: alignment targets are
detached, so there is no backward kernel.

The kernel has two variants, and ``mas_plan`` picks one from (Ty, Tx):
the warp variant (one warp per item, decision bits in shared memory) where
Tx <= 1024 and its 4 * Ty * (K + 1) bytes of shared memory fit in
``SMEM_BYTES``; the wide variant (a block of up to ``MAX_WARPS`` warps per
item, strips of 8192 columns one after the other, decision bits in a
global scratch) everywhere else. Together they take any [B, Ty, Tx] the
card's memory holds.

Recurrence (all paths, bit for bit):
  acc[y, x] = value[y, x] + max(acc[y-1, x-1], acc[y-1, x])
with the x == y diagonal forced to come from the diagonal predecessor and
x == 0 only allowed at y == 0, then a serial one-hot backtrace.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

MAX_NEG = -1e9
WARP_COLUMNS = 1024   # 32 lanes x 32 columns: what one warp holds in registers
SMEM_BYTES = 232_448  # dynamic shared memory one block may have on the H100
MAX_WARPS = 8         # warps of one wide block (a strip of 8192 columns)
# the wide kernel's shared memory (csrc/monotonic_align.cu, kWideSmem): 33
# words of hand-over slots, length sums and the backtrace's column, then
# 256 staged rows of 9 decision words
WIDE_SMEM_BYTES = (4 * MAX_WARPS + 1 + 256 * 9) * 4


class MasPlan(NamedTuple):
    """How the kernel runs one [B, Ty, Tx] call (see mas_plan)."""
    variant: str        # "warp" or "wide"
    k: int              # columns per lane: a power of two, at most 32
    warps: int          # warps per batch item
    strips: int         # column strips, run one after the other
    smem_bytes: int     # dynamic shared memory of one block
    scratch_bytes: int  # global scratch per batch item


def mas_plan(t_y: int, t_x: int) -> MasPlan:
    """The kernel variant for a [B, Ty, Tx] call, with its shared memory
    and its global scratch per item (both in bytes).

    The warp variant has one warp, K the power of two >= Tx / 32, and
    holds the decision bits [Ty, K] and the path's columns [Ty] in shared
    memory. Where it does not fit, the wide variant (``wide_plan``)."""
    k = 1 << (min(-(-t_x // 32), 32) - 1).bit_length()
    smem = 4 * t_y * (k + 1)
    if t_x <= WARP_COLUMNS and smem <= SMEM_BYTES:
        return MasPlan("warp", k, 1, 1, smem, 0)
    return wide_plan(t_y, t_x)


def wide_plan(t_y: int, t_x: int, k: int | None = None) -> MasPlan:
    """The wide variant at ``k`` columns per lane: as many warps as the
    row needs, at most MAX_WARPS, and strips past them. It keeps the bits
    and columns in the scratch (bits [Ty, ceil(Tx / 32)] words, columns
    [Ty], and two edge columns [2, Ty] when a row has more than one strip)
    and stages the bits through a fixed window of shared memory. ``k``
    defaults to the power of two >= Tx / (32 * MAX_WARPS), at most 32: a
    row costs some K serial steps, so more warps of fewer columns are
    faster. Called alone, it runs the wide variant where the warp variant
    would do (for timing and checking one variant alone)."""
    if k is None:
        per_warp = -(-t_x // (32 * MAX_WARPS))
        k = 1 << (min(per_warp, 32) - 1).bit_length()
    warps = min(MAX_WARPS, -(-t_x // (32 * k)))
    strips = -(-t_x // (warps * 32 * k))
    scratch = 4 * t_y * (-(-t_x // 32) + 1 + (2 if strips > 1 else 0))
    return MasPlan("wide", k, warps, strips, WIDE_SMEM_BYTES, scratch)


def _lengths(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32)
    return t_ys, t_xs


def maximum_path_torch(neg_cent: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version: a Python loop over rows, vectorised over [B, Tx].
    neg_cent, mask: f32 [B, Ty, Tx] -> one-hot monotonic path [B, Ty, Tx]."""
    b, t_y, t_x = neg_cent.shape
    dev = neg_cent.device
    t_ys, t_xs = _lengths(mask)
    values = torch.where(mask > 0, neg_cent,
                         torch.zeros((), device=dev)).float()
    xs = torch.arange(t_x, device=dev)[None, :]
    neg = torch.full((b, 1), MAX_NEG, device=dev)
    rows = []
    prev = torch.full((b, t_x), MAX_NEG, device=dev)
    for y in range(t_y):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        v_prev = torch.where(xs == 0, 0.0 if y == 0 else MAX_NEG, shifted)
        v_cur = torch.where(xs == y, torch.full_like(prev, MAX_NEG), prev)
        lo = torch.clamp(t_xs + y - t_ys, min=0)[:, None]
        hi = torch.clamp(t_xs, max=y + 1)[:, None]
        active = (xs >= lo) & (xs < hi)
        row = values[:, y]
        prev = torch.where(active, row + torch.maximum(v_prev, v_cur), row)
        rows.append(prev)
    acc = torch.stack(rows, dim=1)

    path = torch.zeros_like(values)
    index = (t_xs - 1).long()
    for y in range(t_y - 1, -1, -1):
        active = (y < t_ys) & (index >= 0)
        path[:, y] = ((xs == index[:, None]) & active[:, None]).float()
        if y > 0:
            prev_row = acc[:, y - 1]
            v_stay = prev_row.gather(1, index.clamp(min=0)[:, None])[:, 0]
            v_diag = prev_row.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
            move = (index != 0) & ((index == y) | (v_stay < v_diag))
        else:
            move = torch.zeros_like(active)
        index = torch.where(active & move, index - 1, index)
    return path * mask


class _Kernel:
    """ctypes binding of csrc/monotonic_align.cu, loaded on first launch."""

    fn = None
    wide_fn = None

    @classmethod
    def get(cls):
        if cls.fn is None:
            from .build import load
            fn = load("monotonic_align").mas_forward
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            cls.fn = fn
        return cls.fn

    @classmethod
    def wide(cls):
        if cls.wide_fn is None:
            from .build import load
            fn = load("monotonic_align").mas_forward_wide
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            cls.wide_fn = fn
        return cls.wide_fn


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent, mask: f32 [B, Ty, Tx] -> one-hot monotonic path [B, Ty, Tx].

    ``mask`` is 0/1 and ragged-rectangular: an item's lengths are the sums
    of its first column (frames) and first row (tokens). CUDA tensors launch
    the kernel at any shape, the variant ``mas_plan`` picks
    (``maximum_path.kernel_launches`` counts every launch,
    ``maximum_path.wide_launches`` those of the wide variant), or raise;
    CPU tensors take the plain version (``maximum_path.plain_calls``)."""
    if neg_cent.shape != mask.shape or neg_cent.dim() != 3:
        raise ValueError(f"neg_cent {tuple(neg_cent.shape)} and mask "
                         f"{tuple(mask.shape)} must be the same [B, Ty, Tx]")
    if neg_cent.device.type == "cpu" and mask.device.type == "cpu":
        maximum_path.plain_calls += 1
        return maximum_path_torch(neg_cent, mask)
    if neg_cent.device.type != "cuda" or mask.device != neg_cent.device:
        raise ValueError("maximum_path takes CPU tensors or CUDA tensors on "
                         "one device")
    if neg_cent.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("maximum_path kernel takes float32 neg_cent and mask")
    neg_cent, mask = neg_cent.contiguous(), mask.contiguous()
    path = torch.empty_like(neg_cent)
    if path.numel():
        plan = mas_plan(*neg_cent.shape[1:])
        launch(neg_cent, mask, path, plan)
        maximum_path.kernel_launches += 1
        maximum_path.wide_launches += plan.variant == "wide"
    return path


def launch(neg_cent: torch.Tensor, mask: torch.Tensor, path: torch.Tensor,
           plan: MasPlan) -> None:
    """One launch of the kernel variant ``plan`` names into ``path``, on
    contiguous float32 CUDA tensors of one non-empty shape, on the current
    stream; the wide variant's scratch is allocated here. Counts nothing:
    maximum_path is the entry point."""
    b, t_y, t_x = neg_cent.shape
    stream = torch.cuda.current_stream(neg_cent.device).cuda_stream
    if plan.variant == "warp":
        err = _Kernel.get()(neg_cent.data_ptr(), mask.data_ptr(),
                            path.data_ptr(), b, t_y, t_x, stream)
    else:
        scratch = torch.empty(b * plan.scratch_bytes // 4, dtype=torch.int32,
                              device=neg_cent.device)
        err = _Kernel.wide()(neg_cent.data_ptr(), mask.data_ptr(),
                             path.data_ptr(), b, t_y, t_x, plan.k,
                             plan.warps, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"maximum_path kernel launch failed at B={b}, Ty={t_y}, "
            f"Tx={t_x} ({plan.variant} variant, K={plan.k}, "
            f"{plan.warps} warps, {plan.smem_bytes} bytes of shared memory, "
            f"{b * plan.scratch_bytes} bytes of scratch): cudaError_t {err}")


maximum_path.kernel_launches = 0
maximum_path.wide_launches = 0
maximum_path.plain_calls = 0


def mas_neg_cent(z_p, m_p, logs_p, x_mask, y_mask, logs_clamp: float = 7.0):
    """The VITS negative cross-entropy alignment score and its mask.

    z_p [B, F, C] (posterior sample through the flow), m_p/logs_p [B, T, C]
    (token-level prior BEFORE length regulation), masks [B, F, 1]/[B, T, 1].
    Returns (neg_cent [B, F, T], attn_mask [B, F, T]). The four terms are
    plain matmuls, as in the JAX package, where they sit outside the Pallas
    kernel."""
    logs_p = torch.clamp(logs_p, -logs_clamp, logs_clamp)
    s_p_sq_r = torch.exp(-2.0 * logs_p)
    neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p,
                          dim=-1)[:, None, :]
    neg_cent2 = torch.einsum("bfc,btc->bft", -0.5 * z_p ** 2, s_p_sq_r)
    neg_cent3 = torch.einsum("bfc,btc->bft", z_p, m_p * s_p_sq_r)
    neg_cent4 = torch.sum(-0.5 * (m_p ** 2) * s_p_sq_r, dim=-1)[:, None, :]
    neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4
    attn_mask = y_mask[:, :, 0][:, :, None] * x_mask[:, :, 0][:, None, :]
    return neg_cent.detach(), attn_mask


def mas_duration_targets(z_p, m_p, logs_p, x_mask, y_mask,
                         logs_clamp: float = 7.0) -> torch.Tensor:
    """Monotonic-alignment-search duration targets (frames per phone):
    int32 [B, T]; see mas_neg_cent for the inputs. The score and mask go
    to maximum_path as float32 whatever their dtype (a bf16_run step's),
    as the JAX package casts before its kernel."""
    neg_cent, attn_mask = mas_neg_cent(z_p, m_p, logs_p, x_mask, y_mask,
                                       logs_clamp)
    path = maximum_path(neg_cent.float(), attn_mask.float())
    return path.sum(dim=1).to(torch.int32)
