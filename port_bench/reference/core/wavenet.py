"""WaveNet-style gated dilated conv stack (the VITS "WN" block).

Twin of music_generation_tpu/core/wavenet.py: per-layer weight-normed
dilated convs, tanh*sigmoid gate, residual + skip accumulation, and with
``gin_channels`` > 0 a weight-normed 1x1 ``cond`` conv of the speaker
conditioning ``g`` added to every layer's gate input. [B, T, C] at the
boundary, channels-first inside.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Conv1d


def gated_activation(x_in: torch.Tensor, g_l: Optional[torch.Tensor],
                     channels: int, dim: int = -1) -> torch.Tensor:
    """tanh of the first ``channels`` of x_in + g_l along ``dim`` times the
    sigmoid of the rest (channels-last by default, as the JAX package's;
    ``g_l`` None adds nothing)."""
    acts = x_in if g_l is None else x_in + g_l
    first, second = acts.split([channels, acts.shape[dim] - channels], dim)
    return torch.tanh(first) * torch.sigmoid(second)


class WaveNet(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = self.hidden_channels = hidden_channels
        self.in_layers = nn.ModuleList(
            Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                   weight_norm=True) for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(h, 2 * h if i < n_layers - 1 else h, 1, weight_norm=True)
            for i in range(n_layers))
        # flax builds its cond conv when first called with g; the port
        # builds it from the config
        self.cond = (Conv1d(gin_channels, 2 * h * n_layers, 1,
                            weight_norm=True) if gin_channels else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, H], mask [B, T, 1], g [B, 1, gin] or None ->
        [B, T, H]."""
        h = self.hidden_channels
        x, m = x.transpose(1, 2), mask.transpose(1, 2)
        g_all = None
        if g is not None:
            if self.cond is None:
                raise ValueError("speaker conditioning g given to a WaveNet "
                                 "built with gin_channels=0")
            g_all = self.cond(g.transpose(1, 2))           # [B, 2hL, 1]
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (conv_in, res_skip) in enumerate(zip(self.in_layers,
                                                    self.res_skip_layers)):
            g_l = (None if g_all is None
                   else g_all[:, i * 2 * h:(i + 1) * 2 * h])
            acts = gated_activation(conv_in(x), g_l, h, dim=1)
            rs = res_skip(acts)
            if i < last:
                x = (x + rs[:, :h]) * m
                output = output + rs[:, h:]
            else:
                output = output + rs
        return (output * m).transpose(1, 2)
