"""Monotonic alignment search, the plain way: a NumPy dynamic program.

The recurrence is VITS's, item by item:

  acc[y, x] = value[y, x] + max(acc[y-1, x-1], acc[y-1, x])

over the band an item of ``t_y`` frames and ``t_x`` phones allows (x == 0
only at y == 0, the diagonal x == y only from its diagonal predecessor),
then a backtrace from the last phone that stays on a column where
``acc[y-1, x] >= acc[y-1, x-1]``. The sums are float32, as the model's
score is. On a meta tensor (FLOP counting) the path is zeros of the right
shape: the search is not a FLOP the counts take in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_NEG = np.float32(-1e9)


def maximum_path_numpy(value: np.ndarray, t_y: int, t_x: int) -> np.ndarray:
    """One item: value float32 [Ty_pad, Tx_pad] -> one-hot path of the same
    shape, zero outside [t_y, t_x]."""
    path = np.zeros(value.shape, np.float32)
    if t_y <= 0 or t_x <= 0:
        return path
    v = value[:t_y, :t_x].astype(np.float32)
    acc = np.full((t_y, t_x), MAX_NEG, np.float32)
    xs = np.arange(t_x)
    for y in range(t_y):
        lo, hi = max(0, t_x + y - t_y), min(t_x, y + 1)
        if y == 0:
            prev_cur = np.full(t_x, MAX_NEG, np.float32)
            prev_diag = np.where(xs == 0, np.float32(0), MAX_NEG)
        else:
            prev_cur = np.where(xs == y, MAX_NEG, acc[y - 1])
            prev_diag = np.concatenate([[MAX_NEG], acc[y - 1, :-1]]).astype(
                np.float32)
            prev_diag = np.where(xs == 0, MAX_NEG, prev_diag)
        row = v[y] + np.maximum(prev_diag, prev_cur)
        active = (xs >= lo) & (xs < hi)
        acc[y] = np.where(active, row, v[y])
    index = t_x - 1
    for y in range(t_y - 1, -1, -1):
        path[y, index] = 1.0
        if y > 0 and index != 0 and (
                index == y or acc[y - 1, index] < acc[y - 1, index - 1]):
            index -= 1
    return path


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, Ty, Tx] score and 0/1 mask -> one-hot path, on the score's
    device; the lengths are the mask's first column and first row."""
    if neg_cent.device.type == "meta":
        return torch.zeros_like(neg_cent)
    value = neg_cent.detach().float().cpu().numpy()
    m = mask.detach().float().cpu().numpy()
    t_ys = m[:, :, 0].sum(axis=1).astype(np.int64)
    t_xs = m[:, 0, :].sum(axis=1).astype(np.int64)
    out = np.stack([maximum_path_numpy(value[i], int(t_ys[i]), int(t_xs[i]))
                    for i in range(value.shape[0])])
    return torch.from_numpy(out).to(neg_cent.device) * mask


def mas_neg_cent(z_p, m_p, logs_p, x_mask, y_mask, logs_clamp: float = 7.0):
    """The VITS alignment score [B, F, T] and its mask: the Gaussian
    log-likelihood of each frame of z_p under each phone's prior."""
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
    """Frames per phone, int32 [B, T], of the most likely monotonic
    alignment."""
    neg_cent, attn_mask = mas_neg_cent(z_p, m_p, logs_p, x_mask, y_mask,
                                       logs_clamp)
    path = maximum_path(neg_cent.float(), attn_mask.float())
    return path.sum(dim=1).to(torch.int32)
