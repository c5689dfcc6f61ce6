"""iSTFT and multi-band iSTFT vocoder decoders.

Twin of music_generation_tpu/models/svs/istft.py (after arXiv 2210.15975,
MB-iSTFT-VITS): the HiFi-GAN trunk runs at a lower rate and an inverse STFT
head (and, in the multi-band variant, a fixed PQMF synthesis filterbank)
makes the last upsampling. The arithmetic is the JAX package's, not
``torch.istft``'s: a real-basis irfft product, a periodic Hann synthesis
window, ``n_fft / hop`` static overlap-adds, division by the window-sum
envelope (floored at 1e-6) and a trim to ``t * hop`` samples. Both
generators keep the HiFi-GAN contract [B, T_frames, C] ->
[B, T_frames * hop_length, 1]. Checkpoints trained with one decoder type do
not load into another.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.layers import Conv1d
from .hifigan import HiFiGANTrunk


def _hann(n_fft: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's convention)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)


@functools.lru_cache(maxsize=64)
def _istft_constants(n_fft: int, hop: int, t: int, dtype: torch.dtype,
                     device: torch.device):
    """(cos basis, sin basis [n_bins, n_fft], window [n_fft], window-sum
    envelope [t * hop]) on ``device``: built once per shape, so
    a warm call copies nothing from the host."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    # x[n] = 1/N sum_k w_k (Re_k cos(2 pi k n / N) - Im_k sin(...)),
    # w_k = 1 for k in {0, N/2}, else 2
    w = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0) / n_fft
    total = t * hop + (n_fft - hop)
    env = np.zeros(total, np.float64)
    for i in range(t):
        env[i * hop: i * hop + n_fft] += _hann(n_fft)
    # divided in the output's dtype, as the JAX package divides
    env = torch.as_tensor(np.maximum(env, 1e-6)[: t * hop], dtype=dtype)
    return tuple(torch.as_tensor(a, dtype=dtype).to(device) for a in (
        w * np.cos(2 * np.pi * k * n / n_fft),
        w * np.sin(2 * np.pi * k * n / n_fft), _hann(n_fft))) + (
        env.to(device),)


def istft_overlap_add(mag: torch.Tensor, phase: torch.Tensor, n_fft: int,
                      hop: int) -> torch.Tensor:
    """[B, T, n_fft//2+1] magnitude and phase frames -> [B, T * hop]
    samples: windowed irfft, overlap-add, window-sum normalisation."""
    assert n_fft % hop == 0, (n_fft, hop)
    b, t, _ = mag.shape
    cos_b, sin_b, win, env = _istft_constants(n_fft, hop, t, mag.dtype,
                                              mag.device)
    frames = (mag * torch.cos(phase)) @ cos_b - (mag * torch.sin(phase)) \
        @ sin_b
    frames = frames * win                                  # [B, T, n_fft]
    r = n_fft // hop                # frames overlapping each output sample
    chunks = frames.reshape(b, t, r, hop)
    # chunk k of frame i lands at i*hop + k*hop; the trim keeps t*hop
    # samples, so chunk k contributes its first t - k frames at k*hop
    out = chunks[:, :, 0].reshape(b, t * hop)
    for k in range(1, min(r, t)):
        flat = chunks[:, : t - k, k].reshape(b, (t - k) * hop)
        out = out + torch.nn.functional.pad(flat, (k * hop, 0))
    return out / env


def pqmf_filters(subbands: int, taps: int = 62, cutoff: float = 0.142,
                 beta: float = 9.0, synthesis: bool = False) -> np.ndarray:
    """Cosine-modulated Kaiser prototype filterbank, [subbands, taps + 1]
    (near-perfect-reconstruction PQMF); the synthesis bank differs from the
    analysis bank by the sign of the (-1)^k pi/4 phase term."""
    from scipy.signal import firwin
    proto = firwin(taps + 1, cutoff, window=("kaiser", beta))
    n = np.arange(taps + 1)
    sign = -1.0 if synthesis else 1.0
    filters = np.zeros((subbands, taps + 1))
    for k in range(subbands):
        filters[k] = (2 * proto *
                      np.cos((2 * k + 1) * np.pi / (2 * subbands)
                             * (n - taps / 2)
                             + sign * (-1) ** k * np.pi / 4))
    return filters


def pqmf_synthesis(bands: torch.Tensor, filters) -> torch.Tensor:
    """[B, T, S] sub-band signals -> [B, T * S] full-band signal: each band
    zero-stuffed by S, then one conv over the stacked bands with the
    synthesis filters ``filters`` ([S, taps + 1], numpy or a tensor),
    flipped (conv1d is a correlation) and scaled by S."""
    b, t, s = bands.shape
    taps = filters.shape[1] - 1
    up = torch.stack([bands] + [torch.zeros_like(bands)] * (s - 1), dim=2)
    up = up.reshape(b, t * s, s).transpose(1, 2)           # [B, S, T*S]
    kernel = torch.as_tensor(filters, dtype=bands.dtype,
                             device=bands.device).flip(-1)[None] * s
    up = torch.nn.functional.pad(up, (taps // 2, taps - taps // 2))
    return torch.nn.functional.conv1d(up, kernel)[:, 0]


def _mag_phase(h: torch.Tensor, n_bins: int):
    mag = torch.exp(torch.clamp(h[..., :n_bins], -10.0, 6.0))
    phase = np.pi * torch.tanh(h[..., n_bins:])
    return mag, phase


class ISTFTGenerator(HiFiGANTrunk):
    """HiFi-GAN trunk at a low rate + one iSTFT head.
    prod(upsample_rates) * istft_hop must equal the model's hop_length."""

    def __init__(self, in_channels: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] =
                 ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16),
                 istft_n_fft: int = 16, istft_hop: int = 4,
                 gin_channels: int = 0):
        super().__init__(in_channels, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         gin_channels)
        self.n_fft, self.hop = istft_n_fft, istft_hop
        self.n_bins = istft_n_fft // 2 + 1
        self.istft_head = Conv1d(self.out_channels, 2 * self.n_bins, 7)

    def forward(self, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.istft_head(self.trunk(x, g=g)).transpose(1, 2)
        mag, phase = _mag_phase(h, self.n_bins)
        audio = istft_overlap_add(mag, phase, self.n_fft, self.hop)
        return torch.tanh(audio)[..., None]


class MBISTFTGenerator(HiFiGANTrunk):
    """Multi-band variant: the trunk, at an even lower rate, emits
    ``subbands`` iSTFT heads and the fixed PQMF synthesis bank recombines
    the bands. prod(upsample_rates) * istft_hop * subbands == hop_length."""

    def __init__(self, in_channels: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] =
                 ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (4, 4),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (8, 8),
                 istft_n_fft: int = 16, istft_hop: int = 4,
                 subbands: int = 4, gin_channels: int = 0):
        super().__init__(in_channels, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         gin_channels)
        self.n_fft, self.hop = istft_n_fft, istft_hop
        self.n_bins = istft_n_fft // 2 + 1
        self.subbands = subbands
        self.istft_head = Conv1d(self.out_channels,
                                 2 * self.n_bins * subbands, 7)
        # a buffer, so it moves with the module; not saved (float64: cast to
        # the bands' dtype at each call)
        self.register_buffer("pqmf", torch.as_tensor(
            pqmf_filters(subbands, synthesis=True)), persistent=False)

    def forward(self, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.istft_head(self.trunk(x, g=g)).transpose(1, 2)
        b, t, _ = h.shape
        mag, phase = _mag_phase(
            h.reshape(b, t, self.subbands, 2 * self.n_bins), self.n_bins)
        # the S bands as one batch of B*S iSTFTs
        bands = istft_overlap_add(
            mag.transpose(1, 2).reshape(b * self.subbands, t, self.n_bins),
            phase.transpose(1, 2).reshape(b * self.subbands, t, self.n_bins),
            self.n_fft, self.hop)
        bands = bands.reshape(b, self.subbands, -1).transpose(1, 2)
        return torch.tanh(pqmf_synthesis(bands, self.pqmf))[..., None]
