"""Monotonic alignment search (VITS MAS): CUDA kernel + plain PyTorch version.

Twin of music_generation_tpu/ops/monotonic_align.py. ``maximum_path``
launches the hand-written Hopper kernel (csrc/monotonic_align.cu, which
replaces the Pallas kernel ``_mas_kernel``) for CUDA tensors and takes the
plain version ``maximum_path_torch`` only for CPU tensors; it never falls
back from one to the other. MAS is forward-only: alignment targets are
detached, so there is no backward kernel.

Recurrence (all paths, bit for bit):
  acc[y, x] = value[y, x] + max(acc[y-1, x-1], acc[y-1, x])
with the x == y diagonal forced to come from the diagonal predecessor and
x == 0 only allowed at y == 0, then a serial one-hot backtrace.
"""

from __future__ import annotations

import ctypes
import math

import torch

MAX_NEG = -1e9
MAX_TX = 1024  # 32 columns per lane of one warp


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


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent, mask: f32 [B, Ty, Tx] -> one-hot monotonic path [B, Ty, Tx].

    ``mask`` is 0/1 and ragged-rectangular: an item's lengths are the sums
    of its first column (frames) and first row (tokens). CUDA tensors launch
    the kernel (``maximum_path.kernel_launches`` counts
    them) or raise; CPU tensors take the plain version
    (``maximum_path.plain_calls``)."""
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
    b, t_y, t_x = neg_cent.shape
    if t_x > MAX_TX:
        raise ValueError(f"maximum_path kernel takes Tx <= {MAX_TX}, "
                         f"got {t_x}")
    neg_cent, mask = neg_cent.contiguous(), mask.contiguous()
    path = torch.empty_like(neg_cent)
    if b == 0 or t_y == 0 or t_x == 0:
        return path.zero_()
    err = _Kernel.get()(
        neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_y, t_x,
        torch.cuda.current_stream(neg_cent.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"maximum_path kernel launch failed at Ty={t_y}, Tx={t_x}: "
            f"cudaError_t {err} (a block keeps 4 * Ty * (K + 1) bytes of "
            f"shared memory, K the power of two >= Tx / 32, at most 227 KB)")
    maximum_path.kernel_launches += 1
    return path


maximum_path.kernel_launches = 0
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
