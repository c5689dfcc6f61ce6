"""Duration predictors shared by the SVS model and the melody models.

Twins of music_generation_tpu/models/duration.py:
- DurationPredictor: the SVS model's 3-conv sigmoid head predicting each
  phone's fraction of its note duration.
- LogDurationPredictor: the same trunk with a linear output (log-durations)
  and optional conditioning ``g``.
- StochasticDurationPredictor: the VITS normalising-flow duration model of
  the SDP melody variant: sampling, and the NLL it trains on.
Layout [B, T, C] features, [B, T, 1] masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.flows import ConvFlow, ElementwiseAffine, LogFlow, flip
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

    def _trunk(self, x, mask, deterministic, generator) -> torch.Tensor:
        for conv, norm in zip(self.conv, self.norm):
            x = norm(torch.relu(conv_ntc(conv, x * mask)))
            x = dropout(x, self.dropout_rate, deterministic, generator)
        return conv_ntc(self.proj, x * mask)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> [B, T] fraction in (0, 1)."""
        x = self._trunk(x.detach(), mask, deterministic, generator)
        return (torch.sigmoid(x) * mask)[..., 0]


class LogDurationPredictor(DurationPredictor):
    """DurationPredictor's trunk with a linear output: log-durations [B, T],
    masked. With ``gin_channels`` > 0 a 1x1 ``cond`` conv of the
    conditioning g [B, 1 or T, gin] is added to the (detached) input."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, dropout_rate: float = 0.0,
                 gin_channels: int = 0):
        super().__init__(in_channels, filter_channels, kernel_size,
                         dropout_rate)
        self.cond = (Conv1d(gin_channels, in_channels, 1) if gin_channels
                     else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.detach()
        if g is not None:
            if self.cond is None:
                raise ValueError("conditioning g given to a "
                                 "LogDurationPredictor built with "
                                 "gin_channels=0")
            x = x + conv_ntc(self.cond, g.detach())
        x = self._trunk(x, mask, deterministic, generator)
        return x[..., 0] * mask[..., 0]


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model. ``forward`` is the reverse direction:
    log-durations sampled from noise, through the trunk (pre, convs,
    proj), the elementwise affine and spec flows n_flows-1..1 (the reverse
    pass skips flow 0, as the reference does, VISinger/models.py:90-91).
    ``nll`` is the forward (training) direction, the NLL of given
    durations; it also needs flow 0 and the posterior (post_pre,
    post_convs, post_proj, post_ea, post_flow 0-3), which only ``nll=True``
    builds. The two DDSConv stacks drop out at ``dropout_rate``."""

    def __init__(self, in_channels: int, kernel_size: int,
                 dropout_rate: float = 0.0, n_flows: int = 4,
                 nll: bool = False):
        super().__init__()
        fc = in_channels  # the reference overrides filter_channels
        self.n_flows = n_flows
        self.pre = Conv1d(in_channels, fc, 1)
        self.convs = DDSConv(fc, kernel_size, 3, dropout_rate)
        self.proj = Conv1d(fc, fc, 1)
        self.ea = ElementwiseAffine(2)
        self.flow = nn.ModuleDict({
            str(i): ConvFlow(2, fc, kernel_size, n_layers=3)
            for i in range(0 if nll else 1, n_flows)})
        if nll:
            self.post_pre = Conv1d(1, fc, 1)
            self.post_convs = DDSConv(fc, kernel_size, 3, dropout_rate)
            self.post_proj = Conv1d(fc, fc, 1)
            self.post_ea = ElementwiseAffine(2)
            self.post_flow = nn.ModuleDict({
                str(i): ConvFlow(2, fc, kernel_size, n_layers=3)
                for i in range(4)})
            self.log_flow = LogFlow()

    def _trunk(self, x, mask, deterministic: bool = True,
               generator: Optional[torch.Generator] = None):
        h = self.convs(conv_ntc(self.pre, x.detach()), mask,
                       deterministic=deterministic, generator=generator)
        return conv_ntc(self.proj, h) * mask

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """x [B, T, C], mask [B, T, 1], noise [B, T, 2] (already scaled)
        -> log-durations [B, T]."""
        x = self._trunk(x, mask)
        z = noise
        for i in reversed(range(1, self.n_flows)):
            z = self.flow[str(i)](flip(z), mask, g=x, reverse=True)
        z = self.ea(flip(z), mask, reverse=True)
        return z[..., 0]

    def nll(self, x: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
            deterministic: bool = True,
            generator: Optional[torch.Generator] = None,
            e_q: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The NLL [B] of durations w [B, T, 1] given x [B, T, C]: the
        variational posterior (noise ``e_q`` [B, T, 2], else drawn from
        ``generator``, through post_ea and the four posterior flows)
        dequantises w, and the spec flows map it to the normal prior."""
        kw = {"deterministic": deterministic, "generator": generator}
        x = self._trunk(x, mask, **kw)
        b, t, _ = w.shape
        h_w = conv_ntc(self.post_proj, self.post_convs(
            conv_ntc(self.post_pre, w), mask, **kw)) * mask
        if e_q is None:
            e_q = torch.randn((b, t, 2), generator=generator,
                              device=w.device, dtype=w.dtype)
        e_q = e_q * mask
        z_q, logdet_q = self.post_ea(e_q, mask)
        for i in range(len(self.post_flow)):
            z_q, ld = self.post_flow[str(i)](z_q, mask, g=x + h_w)
            logdet_q = logdet_q + ld
            z_q = flip(z_q)
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * mask
        z0 = (w - u) * mask
        logdet_q = logdet_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * mask, dim=(1, 2))
        log_2pi = math.log(2 * math.pi)
        logq = torch.sum(-0.5 * (log_2pi + e_q ** 2) * mask,
                         dim=(1, 2)) - logdet_q
        z0, logdet = self.log_flow(z0, mask)
        z, ld = self.ea(torch.cat([z0, z1], dim=-1), mask)
        logdet = logdet + ld
        for i in range(self.n_flows):
            z, ld = self.flow[str(i)](z, mask, g=x)
            logdet = logdet + ld
            z = flip(z)
        nll = torch.sum(0.5 * (log_2pi + z ** 2) * mask,
                        dim=(1, 2)) - logdet
        return nll + logq
