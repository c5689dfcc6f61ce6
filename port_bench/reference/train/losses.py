"""Training losses for the VISinger GAN-VAE (VITS recipe).

Twin of music_generation_tpu/train/losses.py: LSGAN adversarial + feature
matching + mel L1 + bidirectional KL + duration + F0 + loudness + (AE)
linear-spectrogram reconstruction. Log-scales are clamped to +-LOGS_CLAMP.

The JAX package computes every term on the global batch array. A
data-parallel rank of the port holds only its rows, so with a ``mesh``
(parallel.StepMesh) each function returns this rank's share of the global
term: a masked mean is the local masked sum over the all-reduced
denominator, a plain mean the local mean over the number of ranks (every
rank holds as many rows, of one shape), and the spectral convergence
ratio the global norms' ratio over the ranks. The shares sum to the
global term, and so do their gradients once summed over the ranks. Without
a mesh each is the one-device term.
"""

from __future__ import annotations

import torch

LOGS_CLAMP = 7.0  # bounds exp(+-2 logs) to ~1e6; keeps early GAN steps finite


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, mesh=None,
                 scale: float = 1.0) -> torch.Tensor:
    den = torch.sum(mask)
    if mesh is not None:
        den = mesh.sum(den)
    if scale != 1.0:
        den = den * scale
    return torch.sum(x * mask) / torch.clamp(den, min=1.0)


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """torch.mean(x); with a mesh, this rank's share of the global mean."""
    m = torch.mean(x)
    return m if mesh is None else m / mesh.world


def kl_divergence(z_p, logs_q, m_p, logs_p, mask, mesh=None):
    """KL(q||p) with q given by its sample z_p (the VITS kl_loss form)."""
    logs_p = torch.clamp(logs_p, -LOGS_CLAMP, LOGS_CLAMP)
    logs_q = torch.clamp(logs_q, -LOGS_CLAMP, LOGS_CLAMP)
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return _masked_mean(kl, mask, mesh)


def gaussian_nll(x, m, logs, mask, mesh=None):
    """Mean negative log-likelihood of x under N(m, exp(logs)) (the
    reverse-KL surrogate)."""
    logs = torch.clamp(logs, -LOGS_CLAMP, LOGS_CLAMP)
    nll = logs + 0.5 * ((x - m) ** 2) * torch.exp(-2.0 * logs)
    return _masked_mean(nll, mask, mesh)


def duration_loss(fraction_pred, note_durations, phone_durations,
                  frame_seconds, mask, mesh=None):
    """MSE in seconds between predicted phone lengths (fraction * note
    length) and the frame-quantized target durations."""
    pred_seconds = fraction_pred * note_durations
    true_seconds = phone_durations.to(torch.float32) * frame_seconds
    return _masked_mean((pred_seconds - true_seconds) ** 2, mask, mesh)


def f0_loss(log_f0_pred, log_f0_true, mask, mesh=None):
    return _masked_mean(torch.abs(log_f0_pred - log_f0_true), mask, mesh)


def l1_masked(a, b, mask=None, mesh=None):
    d = torch.abs(a - b)
    if mask is None:
        return batch_mean(d, mesh)
    return _masked_mean(d, mask, mesh, scale=d.shape[-1])


def energy_loss(y_fake, y_real, eps: float = 1e-4, mesh=None):
    """Squared log-RMS ratio between generated and real segments. eps is
    added outside the sqrt, as in the JAX package, so an exactly silent
    segment has a NaN gradient there too."""
    rms_f = torch.sqrt(torch.mean(y_fake ** 2, dim=-1)) + eps
    rms_r = torch.sqrt(torch.mean(y_real ** 2, dim=-1)) + eps
    return batch_mean(torch.log(rms_f / rms_r) ** 2, mesh)


def feature_matching_loss(fmap_real, fmap_gen, mesh=None):
    loss = 0.0
    for fr, fg in zip(fmap_real, fmap_gen):
        for r, g in zip(fr, fg):
            loss = loss + batch_mean(torch.abs(r.detach() - g), mesh)
    return loss * 2.0


def generator_adv_loss(disc_gen_outputs, mesh=None):
    loss = 0.0
    for dg in disc_gen_outputs:
        loss = loss + batch_mean((1.0 - dg) ** 2, mesh)
    return loss


def discriminator_adv_loss(disc_real_outputs, disc_gen_outputs, mesh=None):
    loss = 0.0
    for dr, dg in zip(disc_real_outputs, disc_gen_outputs):
        loss = (loss + batch_mean((1.0 - dr) ** 2, mesh)
                + batch_mean(dg ** 2, mesh))
    return loss


def mas_duration_targets(z_p, m_p, logs_p, x_mask, y_mask):
    """MAS duration targets (frames per phone) with log-scales clamped to
    +-LOGS_CLAMP: ops.mas_duration_targets, re-exported as the JAX package
    does (the model's training forward calls the ops version itself)."""
    from ..mas import mas_duration_targets as mas
    return mas(z_p, m_p, logs_p, x_mask, y_mask, logs_clamp=LOGS_CLAMP)
