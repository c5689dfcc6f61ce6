"""HiFi-GAN generator (the SVS vocoder).

Twin of Generator / ResBlock1 / ResBlock2 in
music_generation_tpu/models/svs/hifigan.py (upsample 8/8/2/2, kernel
16/16/4/4, ResBlock1 k=3/7/11 d=(1,3,5)). The discriminators belong to
training and are not ported yet. Channels-first inside; the generator
takes [B, T_frames, C] and returns [B, T_frames * prod(rates), 1].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.layers import LRELU_SLOPE, Conv1d, ConvTranspose1d


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.conv1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   weight_norm=True) for d in dilations)
        self.conv2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, weight_norm=True)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.conv1, self.conv2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(xt, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3)):
        super().__init__()
        self.conv = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   weight_norm=True) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.conv:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    def __init__(self, in_channels: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] =
                 ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)):
        super().__init__()
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = Conv1d(in_channels, upsample_initial_channel, 7)
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates,
                                       upsample_kernel_sizes)):
            nxt = upsample_initial_channel // (2 ** (i + 1))
            self.up.append(ConvTranspose1d(ch, nxt, k, u))
            self.res.append(nn.ModuleList(
                res_cls(nxt, rk, tuple(rd)) for rk, rd in
                zip(resblock_kernel_sizes, resblock_dilation_sizes)))
            ch = nxt
        # small-init output projection (1e-4 x the fan-in scale), as in the
        # JAX package: random-init audio starts in tanh's linear region
        self.conv_post = Conv1d(ch, 1, 7, bias=False, init_scale=1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x.transpose(1, 2))
        for up, blocks in zip(self.up, self.res):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for block in blocks:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / len(blocks)
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x).transpose(1, 2)
