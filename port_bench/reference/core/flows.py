"""The mean-only residual coupling flow (the VITS spec_flow).

Twin of music_generation_tpu/core/flows.py's coupling flow. Layout
[B, T, C]; masks [B, T, 1]. Mean-only coupling has a zero
log-determinant, so both its directions return the transformed tensor
alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Conv1d, conv_ntc
from .wavenet import WaveNet


def flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-1,))


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling: the first half drives a WaveNet that
    shifts the second half. The output projection starts at zero, so a
    freshly initialised layer is the identity. With ``gin_channels`` > 0
    the WaveNet also takes the speaker conditioning ``g``."""

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate,
                           n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1, init_scale=0.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = conv_ntc(self.pre, x0) * mask
        h = self.enc(h, mask, g)
        m = conv_ntc(self.post, h) * mask
        y1 = (x1 - m) * mask if reverse else (m + x1) * mask
        return torch.cat([x0, y1], dim=-1)


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + flip)."""

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int,
                 n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        self.coupling = nn.ModuleList(
            ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                  dilation_rate, n_layers, gin_channels)
            for _ in range(n_flows))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                reverse: bool = False) -> torch.Tensor:
        if not reverse:
            for layer in self.coupling:
                x = flip(layer(x, mask, g))
            return x
        for layer in reversed(self.coupling):
            x = layer(flip(x), mask, g, reverse=True)
        return x
