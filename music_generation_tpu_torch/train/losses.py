"""Training losses for the VISinger GAN-VAE (VITS recipe).

Twin of music_generation_tpu/train/losses.py: LSGAN adversarial + feature
matching + mel L1 + bidirectional KL + duration + F0 + loudness + (AE)
linear-spectrogram reconstruction, and the optional multi-resolution STFT
loss. Log-scales are clamped to +-LOGS_CLAMP.
"""

from __future__ import annotations

import torch

from ..audio.stft import spectrogram

LOGS_CLAMP = 7.0  # bounds exp(+-2 logs) to ~1e6; keeps early GAN steps finite


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def kl_divergence(z_p, logs_q, m_p, logs_p, mask):
    """KL(q||p) with q given by its sample z_p (the VITS kl_loss form)."""
    logs_p = torch.clamp(logs_p, -LOGS_CLAMP, LOGS_CLAMP)
    logs_q = torch.clamp(logs_q, -LOGS_CLAMP, LOGS_CLAMP)
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return _masked_mean(kl, mask)


def gaussian_nll(x, m, logs, mask):
    """Mean negative log-likelihood of x under N(m, exp(logs)) (the
    reverse-KL surrogate)."""
    logs = torch.clamp(logs, -LOGS_CLAMP, LOGS_CLAMP)
    nll = logs + 0.5 * ((x - m) ** 2) * torch.exp(-2.0 * logs)
    return _masked_mean(nll, mask)


def duration_loss(fraction_pred, note_durations, phone_durations,
                  frame_seconds, mask):
    """MSE in seconds between predicted phone lengths (fraction * note
    length) and the frame-quantized target durations."""
    pred_seconds = fraction_pred * note_durations
    true_seconds = phone_durations.to(torch.float32) * frame_seconds
    return _masked_mean((pred_seconds - true_seconds) ** 2, mask)


def f0_loss(log_f0_pred, log_f0_true, mask):
    return _masked_mean(torch.abs(log_f0_pred - log_f0_true), mask)


def l1_masked(a, b, mask=None):
    d = torch.abs(a - b)
    if mask is None:
        return torch.mean(d)
    return torch.sum(d * mask) / torch.clamp(torch.sum(mask) * d.shape[-1],
                                             min=1.0)


def multires_stft_loss(y_fake, y_real,
                       resolutions=((512, 128), (1024, 256), (2048, 512))):
    """Multi-resolution STFT loss (Parallel WaveGAN eq. 4-6): spectral
    convergence + log-magnitude L1, averaged over the resolutions the
    segment can fill (or one that fits, for a short segment)."""
    n = y_fake.shape[-1]
    resolutions = [r for r in resolutions if r[0] <= n] \
        or [(max(8, 1 << (int(n).bit_length() - 1)), max(2, n // 4))]
    total = 0.0
    for n_fft, hop in resolutions:
        s_fake = spectrogram(y_fake, n_fft=n_fft, hop=hop, win_length=n_fft)
        s_real = spectrogram(y_real, n_fft=n_fft, hop=hop, win_length=n_fft)
        sc = torch.linalg.vector_norm(s_real - s_fake) / torch.clamp(
            torch.linalg.vector_norm(s_real), min=1e-6)
        log_l1 = torch.mean(torch.abs(
            torch.log(torch.clamp(s_real, min=1e-5))
            - torch.log(torch.clamp(s_fake, min=1e-5))))
        total = total + sc + log_l1
    return total / len(resolutions)


def energy_loss(y_fake, y_real, eps: float = 1e-4):
    """Squared log-RMS ratio between generated and real segments. eps is
    added outside the sqrt, as in the JAX package, so an exactly silent
    segment has a NaN gradient there too."""
    rms_f = torch.sqrt(torch.mean(y_fake ** 2, dim=-1)) + eps
    rms_r = torch.sqrt(torch.mean(y_real ** 2, dim=-1)) + eps
    return torch.mean(torch.log(rms_f / rms_r) ** 2)


def feature_matching_loss(fmap_real, fmap_gen):
    loss = 0.0
    for fr, fg in zip(fmap_real, fmap_gen):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r.detach() - g))
    return loss * 2.0


def generator_adv_loss(disc_gen_outputs):
    loss = 0.0
    for dg in disc_gen_outputs:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def discriminator_adv_loss(disc_real_outputs, disc_gen_outputs):
    loss = 0.0
    for dr, dg in zip(disc_real_outputs, disc_gen_outputs):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss
