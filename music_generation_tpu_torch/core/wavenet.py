"""WaveNet-style gated dilated conv stack (the VITS "WN" block).

Twin of music_generation_tpu/core/wavenet.py: per-layer weight-normed
dilated convs, tanh*sigmoid gate, residual + skip accumulation. [B, T, C]
at the boundary, channels-first inside.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1d


class WaveNet(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int):
        super().__init__()
        h = self.hidden_channels = hidden_channels
        self.in_layers = nn.ModuleList(
            Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                   weight_norm=True) for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(h, 2 * h if i < n_layers - 1 else h, 1, weight_norm=True)
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, H], mask [B, T, 1] -> [B, T, H]."""
        h = self.hidden_channels
        x, m = x.transpose(1, 2), mask.transpose(1, 2)
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (conv_in, res_skip) in enumerate(zip(self.in_layers,
                                                    self.res_skip_layers)):
            x_in = conv_in(x)
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            rs = res_skip(acts)
            if i < last:
                x = (x + rs[:, :h]) * m
                output = output + rs[:, h:]
            else:
                output = output + rs
        return (output * m).transpose(1, 2)
