"""Basic 1-D building blocks.

Twin of music_generation_tpu/core/layers.py. Convolutions take torch's
channels-first [B, C, T]; the modules built from them keep the JAX
package's channels-last [B, T, C] at their boundaries (``conv_ntc``).

Weight norm is stored as the JAX package stores it: a raw kernel ``weight``
plus a per-output-channel gain ``g``; the effective kernel is
``weight * g / max(||weight[o]||, 1e-12)``, the norm taken per OUTPUT
channel (for ConvTranspose1d that is dim 1 of the [in, out, k] weight, not
the dim 0 that torch.nn.utils.weight_norm would pick).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: with ``deterministic`` False, zero each element
    with probability ``rate`` (drawn from ``generator``) and scale the rest
    by 1 / (1 - rate). A module's training mode plays no part."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype)
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def same_pad(kernel_size: int, dilation: int = 1) -> tuple[int, int]:
    span = (kernel_size - 1) * dilation
    return (span // 2, span - span // 2)


def lecun_normal_(w: torch.Tensor, fan_in: int, scale: float = 1.0):
    return nn.init.trunc_normal_(w, std=(scale / fan_in) ** 0.5)


class Conv1d(nn.Module):
    """1-D conv on [B, C, T] with 'same' padding (JAX split for even spans),
    optional channel groups and optional weight norm (kernel, g)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 weight_norm: bool = False, init_scale: float = 1.0):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.pad = same_pad(kernel_size, dilation)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.g = nn.Parameter(torch.empty(out_channels)) if weight_norm \
            else None
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        if init_scale == 0.0:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, in_channels // groups * kernel_size,
                          init_scale)
        if self.g is not None:
            with torch.no_grad():
                self.g.copy_(self.weight.flatten(1).norm(dim=1))

    def effective_weight(self) -> torch.Tensor:
        if self.g is None:
            return self.weight
        norm = self.weight.flatten(1).norm(dim=1).clamp_min(1e-12)
        return self.weight * (self.g / norm)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = self.pad
        if left != right:
            x = F.pad(x, (left, right))
            left = 0
        return F.conv1d(x, self.effective_weight(), self.bias,
                        stride=self.stride, padding=left,
                        dilation=self.dilation, groups=self.groups)


def conv_ntc(conv: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to channels-last [B, T, C]; a 1x1 conv is a linear."""
    w = conv.effective_weight()
    if w.shape[-1] == 1 and conv.stride == 1 and conv.groups == 1:
        return F.linear(x, w[..., 0], conv.bias)
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed conv matching torch ConvTranspose1d(k, u, p=(k-u)//2):
    output length is exactly T * stride (for even k-u). Always weight-normed
    (the HiFi-GAN upsamplers). Weight layout [in, out, k]; the JAX kernel
    [k, in, out] maps onto it flipped along k."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        # lecun over the effective fan-in (each output sums in * k / stride
        # terms) keeps the activation scale, so an untrained vocoder is
        # audible; the JAX package's normal(0.01) loses ~1e-3 of it over
        # the four HiFi-GAN upsamplers
        lecun_normal_(self.weight, in_channels * kernel_size // stride)
        self.g = nn.Parameter(self.weight.detach().transpose(0, 1)
                              .flatten(1).norm(dim=1).clone())
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def effective_weight(self) -> torch.Tensor:
        norm = self.weight.transpose(0, 1).flatten(1).norm(dim=1)
        return self.weight * (self.g / norm.clamp_min(1e-12))[None, :, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.effective_weight(), self.bias,
                                  stride=self.stride, padding=self.padding)


def LayerNorm1d(channels: int) -> nn.LayerNorm:
    """LayerNorm over the channel axis of [B, T, C] (eps 1e-5, as the JAX
    package's LayerNorm1d; flax's own default is 1e-6)."""
    return nn.LayerNorm(channels, eps=1e-5)


class FFN(nn.Module):
    """Conv feed-forward on [B, T, C]: conv -> relu -> conv, masked
    (attentions.FFN of the reference)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m = mask.transpose(1, 2)
        h = torch.relu(self.conv_1((x * mask).transpose(1, 2)))
        h = dropout(h, self.dropout_rate, deterministic, generator)
        h = self.conv_2(h * m)
        return (h * m).transpose(1, 2)
