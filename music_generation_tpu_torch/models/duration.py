"""Duration predictors shared by the SVS model and the melody models.

Twins of music_generation_tpu/models/duration.py:
- DurationPredictor: the SVS model's 3-conv sigmoid head predicting each
  phone's fraction of its note duration.
- StochasticDurationPredictor: the VITS normalising-flow duration model of
  the SDP melody variant, in its reverse (sampling) direction.
Layout [B, T, C] features, [B, T, 1] masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.flows import ConvFlow, ElementwiseAffine, flip
from ..core.layers import Conv1d, DDSConv, LayerNorm1d, conv_ntc, dropout


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv = nn.ModuleList(
            Conv1d(in_channels if i == 0 else filter_channels,
                   filter_channels, kernel_size) for i in range(3))
        self.norm = nn.ModuleList(
            LayerNorm1d(filter_channels) for _ in range(3))
        self.proj = Conv1d(filter_channels, 1, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> [B, T] fraction in (0, 1)."""
        x = x.detach()
        for conv, norm in zip(self.conv, self.norm):
            x = norm(torch.relu(conv_ntc(conv, x * mask)))
            x = dropout(x, self.dropout_rate, deterministic, generator)
        x = conv_ntc(self.proj, x * mask)
        return (torch.sigmoid(x) * mask)[..., 0]


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model, reverse direction: log-durations sampled
    from noise. It holds what that direction runs: the trunk (pre, convs,
    proj), the elementwise affine and spec flows 1..n_flows-1; the reverse
    pass skips flow 0 as the reference does (VISinger/models.py:90-91).
    Flow 0 and the posterior flows serve only the NLL (training) direction,
    which is not ported."""

    def __init__(self, in_channels: int, kernel_size: int,
                 n_flows: int = 4):
        super().__init__()
        fc = in_channels  # the reference overrides filter_channels
        self.pre = Conv1d(in_channels, fc, 1)
        self.convs = DDSConv(fc, kernel_size, 3)
        self.proj = Conv1d(fc, fc, 1)
        self.ea = ElementwiseAffine(2)
        self.flow = nn.ModuleDict({
            str(i): ConvFlow(2, fc, kernel_size, n_layers=3)
            for i in range(1, n_flows)})

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """x [B, T, C], mask [B, T, 1], noise [B, T, 2] (already scaled)
        -> log-durations [B, T]."""
        x = conv_ntc(self.proj, self.convs(conv_ntc(self.pre, x.detach()),
                                           mask)) * mask
        z = noise
        for i in reversed(range(1, len(self.flow) + 1)):
            z = self.flow[str(i)](flip(z), mask, g=x, reverse=True)
        z = self.ea(flip(z), mask, reverse=True)
        return z[..., 0]
