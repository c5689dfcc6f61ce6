"""HiFi-GAN vocoder: generator and the multi-period/scale discriminators.

Twin of music_generation_tpu/models/svs/hifigan.py (upsample 8/8/2/2,
kernel 16/16/4/4, ResBlock1 k=3/7/11 d=(1,3,5); MPD periods 2/3/5/7/11 plus
one scale discriminator). Channels-first inside; the generator takes
[B, T_frames, C] and returns [B, T_frames * prod(rates), 1], and the
discriminators take audio [B, S, 1]. Their feature maps are channels-first
([B, C, T] and, period discriminators, [B, C, T/p, p]) where flax's are
channels-last.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.layers import (LRELU_SLOPE, Conv1d, ConvTranspose1d,
                            lecun_normal_)


def receptive_radius_frames(resblock: str = "1",
                            resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                            resblock_dilation_sizes: Sequence[Sequence[int]]
                            = ((1, 3, 5),) * 3,
                            upsample_rates: Sequence[int] = (8, 8, 2, 2),
                            upsample_kernel_sizes: Sequence[int]
                            = (16, 16, 4, 4), head: float = 3.0) -> int:
    """How many input frames on each side of an output sample the
    HiFi-GAN generator reads, rounded up: conv_pre (k 7), each transposed
    conv (at most ceil(k / u) inputs each side), each stage's widest
    resblock (ResBlock1: (k - 1) / 2 * (d + 1) per dilation d; ResBlock2:
    (k - 1) / 2 * d) and the head, ``head`` samples of the trunk's output
    (conv_post, k 7; the iSTFT decoders' heads: istft.head_reach), each
    reach taken at its stage's rate and summed. The NSF source's strided
    convs (Generator.exc) reach less than their stage's transposed conv,
    so they add nothing. A chunked decode whose halo is at least this
    gives the monolithic decode's samples (SVSSynthesizer._chunked_decode;
    models.svs.visinger.decoder_radius_frames for any decoder type)."""
    reach, rate = 3.0, 1                            # conv_pre, in frames
    for u, k in zip(upsample_rates, upsample_kernel_sizes):
        reach += math.ceil(k / u) / rate            # the transposed conv
        rate *= u
        reach += max(sum((rk - 1) / 2 * (d + (resblock == "1"))
                         for d in rd)
                     for rk, rd in zip(resblock_kernel_sizes,
                                       resblock_dilation_sizes)) / rate
    return math.ceil(reach + head / rate)           # conv_post or head


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


class HiFiGANTrunk(nn.Module):
    """conv_pre, then per upsample rate a leaky ReLU, a weight-normed
    transposed conv and the mean of the resblocks: the learned part shared
    by the HiFi-GAN generator and the iSTFT generators (models/svs/istft.py).
    ``trunk`` takes [B, T_frames, C] and returns channels-first
    [B, out_channels, T_frames * prod(rates)] after a final leaky ReLU
    (slope 0.01). With ``gin_channels`` > 0 a 1x1 ``cond`` conv of the
    speaker conditioning g [B, 1, gin] is added after conv_pre (flax builds
    it when first called with g; the port from the config)."""

    def __init__(self, in_channels: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] =
                 ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 gin_channels: int = 0):
        super().__init__()
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = Conv1d(in_channels, upsample_initial_channel, 7)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels else None)
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        ch = upsample_initial_channel
        self.upsample_rates = tuple(upsample_rates)
        self.stage_channels = []
        for i, (u, k) in enumerate(zip(upsample_rates,
                                       upsample_kernel_sizes)):
            nxt = upsample_initial_channel // (2 ** (i + 1))
            self.stage_channels.append(nxt)
            self.up.append(ConvTranspose1d(ch, nxt, k, u))
            self.res.append(nn.ModuleList(
                res_cls(nxt, rk, tuple(rd)) for rk, rd in
                zip(resblock_kernel_sizes, resblock_dilation_sizes)))
            ch = nxt
        self.out_channels = ch

    def trunk(self, x: torch.Tensor,
              inject: Optional[Callable[[int, torch.Tensor], torch.Tensor]]
              = None, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``inject(i, x)``, when given, replaces the activation after
        upsample stage ``i`` (the NSF source of Generator)."""
        x = self.conv_pre(x.transpose(1, 2))
        if g is not None:
            if self.cond is None:
                raise ValueError("speaker conditioning g given to a decoder "
                                 "built with gin_channels=0")
            x = x + self.cond(g.transpose(1, 2))
        for i, (up, blocks) in enumerate(zip(self.up, self.res)):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if inject is not None:
                x = inject(i, x)
            xs = None
            for block in blocks:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / len(blocks)
        return F.leaky_relu(x)


class Generator(HiFiGANTrunk):
    """The HiFi-GAN generator. With ``nsf`` it also takes the harmonic
    source ``exc`` [B, T_frames * prod(rates), 1] (models/svs/excitation.py)
    and adds, after upsample stage i, a strided conv of it (``exc.{i}``:
    kernel max(2 * stride, 3), stride prod(rates) / (rate so far), so its
    output has exactly the stage's length). Without ``nsf`` the generator
    holds no such conv, so its parameters are the plain generator's."""

    def __init__(self, in_channels: int, *args, nsf: bool = False, **kwargs):
        super().__init__(in_channels, *args, **kwargs)
        # small-init output projection (1e-4 x the fan-in scale), as in the
        # JAX package: random-init audio starts in tanh's linear region
        self.conv_post = Conv1d(self.out_channels, 1, 7, bias=False,
                                init_scale=1e-4)
        self.exc = None
        if nsf:
            total_up = math.prod(self.upsample_rates)
            self.exc = nn.ModuleList()
            rate = 1
            for u, ch in zip(self.upsample_rates, self.stage_channels):
                rate *= u
                stride = total_up // rate
                self.exc.append(Conv1d(1, ch, max(2 * stride, 3),
                                       stride=stride))

    def forward(self, x: torch.Tensor, exc: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        inject = None
        if exc is not None:
            if self.exc is None:
                raise ValueError("an excitation was passed to a generator "
                                 "built without nsf")
            src = exc.transpose(1, 2)                      # [B, 1, S]

            def inject(i, h):
                return h + self.exc[i](src.to(h.dtype))
        elif self.exc is not None:
            raise ValueError("an nsf generator needs its excitation")
        return torch.tanh(self.conv_post(self.trunk(x, inject, g))
                          ).transpose(1, 2)


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad audio [B, S, 1] at the end to a
    multiple of the period, fold it to [B, 1, S/p, p] and run 2-D convs over
    (time, period) with kernel (5, 1), stride (3, 1), padding (2, 0)."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [1, 32, 128, 512, 1024]
        self.conv = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], (5, 1), (3, 1), (2, 0))
            for i in range(4))
        self.conv.append(nn.Conv2d(1024, 1024, (5, 1), 1, (2, 0)))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, (1, 0))
        for conv in [*self.conv, self.conv_post]:  # flax's nn.Conv init
            lecun_normal_(conv.weight, conv.weight[0].numel())
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor):
        b, s, _ = x.shape
        p = self.period
        x = x.transpose(1, 2)
        n_pad = (p - s % p) % p
        if n_pad:
            x = F.pad(x, (0, n_pad), mode="reflect")
        x = x.reshape(b, 1, -1, p)
        fmap = []
        for conv in self.conv:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: weight-normed, grouped 1-D convs on the raw
    waveform."""

    SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
             (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))

    def __init__(self):
        super().__init__()
        chans = [1] + [c for c, _, _, _ in self.SPECS]
        self.conv = nn.ModuleList(
            Conv1d(chans[i], ch, k, stride=st, groups=gr, weight_norm=True)
            for i, (ch, k, st, gr) in enumerate(self.SPECS))
        self.conv_post = Conv1d(1024, 1, 3, weight_norm=True)

    def forward(self, x: torch.Tensor):
        b = x.shape[0]
        x = x.transpose(1, 2)
        fmap = []
        for conv in self.conv:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """One scale discriminator (``disc_s``) and one period discriminator per
    period (``disc_p2`` ...). Real and generated audio go through each
    discriminator as one batch."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.disc_s = DiscriminatorS()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(p))

    def discriminators(self) -> list:
        return [self.disc_s] + [getattr(self, f"disc_p{p}")
                                for p in self.periods]

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, S, 1] -> (real scores, generated scores, real
        feature maps, generated feature maps), one entry per
        discriminator."""
        b = y.shape[0]
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators():
            out, fmap = d(torch.cat([y, y_hat]))
            y_d_rs.append(out[:b])
            y_d_gs.append(out[b:])
            fmap_rs.append([f[:b] for f in fmap])
            fmap_gs.append([f[b:] for f in fmap])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
