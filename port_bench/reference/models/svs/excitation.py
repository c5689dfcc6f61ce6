"""NSF-style harmonic excitation for the vocoder decoder.

Twin of music_generation_tpu/models/svs/excitation.py: a sine source at the
frame F0, generated at the sample rate with a running phase (the cumulative
sum of the instantaneous frequency), which the HiFi-GAN generator injects
after every upsample stage (hifigan.Generator's ``exc`` convs). The source
is made once at full length and sliced beside the latent, so a slice or a
window of it keeps the phase of the whole.
"""

from __future__ import annotations

import math

import torch

# log1p(Hz) threshold below which a frame F0 counts as unvoiced
# (expm1(3.43) ~ 30 Hz, below any singing fundamental)
VOICED_LOG_F0_MIN = 3.43
EXC_AMPLITUDE = 0.1


def harmonic_phase(log_f0: torch.Tensor, hop: int, sample_rate: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-level log1p-F0 [B, T] -> (phase in cycles [B, T*hop], voiced
    frames [B, T] as 0/1 float32). Always float32, whatever the input's
    dtype: the phase integral accumulates ~1e4 cycles over a clip, which a
    bf16 cumsum would destroy. Unvoiced frames add no phase."""
    log_f0 = log_f0.float()
    f0 = torch.expm1(torch.clamp(log_f0, 0.0, 9.0))  # Hz, <= ~8 kHz
    voiced = (log_f0 > VOICED_LOG_F0_MIN).float()
    f0_up = torch.repeat_interleave(f0 * voiced, hop, dim=1)    # [B, S]
    return torch.cumsum(f0_up / sample_rate, dim=1), voiced


def harmonic_excitation(log_f0: torch.Tensor, hop: int, sample_rate: int,
                        amplitude: float = EXC_AMPLITUDE) -> torch.Tensor:
    """Frame-level log1p-F0 [B, T] -> sample-level sine source
    [B, T*hop, 1], float32. Unvoiced frames carry zero signal and zero
    phase advance, so a note after a rest starts from the held phase."""
    cycles, voiced = harmonic_phase(log_f0, hop, sample_rate)
    exc = amplitude * torch.sin(2.0 * math.pi * cycles) \
        * torch.repeat_interleave(voiced, hop, dim=1)
    return exc[..., None]
