"""Normalising-flow layers: the mean-only residual coupling flow (the VITS
spec_flow) and the stochastic duration predictor's flows.

Twin of music_generation_tpu/core/flows.py. Layout [B, T, C]; masks
[B, T, 1]. Mean-only coupling has a zero log-determinant, so both its
directions return the transformed tensor alone. ElementwiseAffine, LogFlow
and ConvFlow return (y, logdet) forward and y in reverse, as the JAX
package's do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import Conv1d, DDSConv, conv_ntc
from .splines import unconstrained_rational_quadratic_spline
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


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs) * x per channel (identity at init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * mask
            return y, torch.sum(self.logs * mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * mask


class LogFlow(nn.Module):
    """y = log(max(x, 1e-5)); reverse exp."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False):
        if not reverse:
            y = torch.log(x.clamp(min=1e-5)) * mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * mask


class ConvFlow(nn.Module):
    """Spline coupling flow: the first half of the channels, through a
    DDSConv stack conditioned on ``g``, parameterises a rational-quadratic
    spline of the second half. The projection starts at zero."""

    num_bins = 10
    tail_bound = 5.0  # identity outside [-tail_bound, tail_bound]

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels,
                           self.half * (self.num_bins * 3 - 1), 1,
                           init_scale=0.0)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.convs(conv_ntc(self.pre, x0), mask, g=g)
        h = conv_ntc(self.proj, h) * mask
        b, t, _ = x0.shape
        h = h.reshape(b, t, self.half, -1)  # [B, T, C/2, 3 * bins - 1]
        scale = math.sqrt(self.filter_channels)
        uw = h[..., :self.num_bins] / scale
        uh = h[..., self.num_bins: 2 * self.num_bins] / scale
        ud = h[..., 2 * self.num_bins:]
        y1, logabsdet = unconstrained_rational_quadratic_spline(
            x1, uw, uh, ud, inverse=reverse, tail_bound=self.tail_bound)
        y = torch.cat([x0, y1], dim=-1) * mask
        if not reverse:
            return y, torch.sum(logabsdet * mask, dim=(1, 2))
        return y
