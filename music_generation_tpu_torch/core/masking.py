"""Shape/mask utilities shared by all models (channels-last [B, T, C]).

Twin of music_generation_tpu/core/masking.py: the same semantics, expressed
with torch gathers and searchsorted.
"""

from __future__ import annotations

from typing import Optional

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, T] bool mask."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def feature_mask(lengths: torch.Tensor, max_length: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, T, 1] float mask (broadcasts over channels)."""
    return sequence_mask(lengths, max_length)[..., None].to(dtype)


def expand_by_durations(x: torch.Tensor, durations: torch.Tensor, t_y: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Length-regulate token features to frames by integer durations.

    x: [B, T_x, C]; durations: [B, T_x] ints. Returns ([B, t_y, C] expanded,
    [B] frame lengths). Each frame takes the first token whose cumulative
    duration exceeds it (a right-sided searchsorted); frames past the total
    repeat the last token, so mask with ``feature_mask(lengths, t_y)``.
    """
    cum = torch.cumsum(durations, dim=-1, dtype=durations.dtype)
    lengths = cum[:, -1]
    frames = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    frames = frames.expand(cum.shape[0], t_y).contiguous()
    idx = torch.searchsorted(cum.contiguous(), frames, right=True)
    idx = idx.clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return out, lengths


def slice_segments(x: torch.Tensor, starts: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Gather fixed-size time slices: x [B, T, C], starts [B] -> [B, S, C].
    As jax.lax.dynamic_slice_in_dim: a negative start counts from the end
    (plus T), then each start is clamped to [0, T - S] so its slice fits."""
    t = x.shape[1]
    starts = torch.where(starts < 0, starts + t, starts).clamp(
        0, max(t - segment_size, 0))
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor,
                        segment_size: int,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Random training slice per batch item: starts = int(u * max(len - S
    + 1, 1)) with u [B] uniform in [0, 1), passed in or drawn from
    ``generator``. Returns (slices [B, S, C], starts [B] int32)."""
    if u is None:
        u = torch.rand(x.shape[0], generator=generator, device=x.device)
    max_start = torch.clamp(lengths - segment_size + 1, min=1)
    starts = (u * max_start.to(u.dtype)).to(torch.int32)
    return slice_segments(x, starts, segment_size), starts
