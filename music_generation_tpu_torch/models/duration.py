"""Phone-duration predictor of the SVS model.

Twin of DurationPredictor in music_generation_tpu/models/duration.py: a
3-conv sigmoid head predicting each phone's fraction of its note duration.
Layout [B, T, C] features, [B, T, 1] masks.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.layers import Conv1d, LayerNorm1d, conv_ntc


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int):
        super().__init__()
        self.conv = nn.ModuleList(
            Conv1d(in_channels if i == 0 else filter_channels,
                   filter_channels, kernel_size) for i in range(3))
        self.norm = nn.ModuleList(
            LayerNorm1d(filter_channels) for _ in range(3))
        self.proj = Conv1d(filter_channels, 1, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """-> [B, T] fraction in (0, 1)."""
        x = x.detach()
        for conv, norm in zip(self.conv, self.norm):
            x = norm(torch.relu(conv_ntc(conv, x * mask)))
        x = conv_ntc(self.proj, x * mask)
        return (torch.sigmoid(x) * mask)[..., 0]
