"""The plain GAN step of VISinger: a discriminator update on a fresh
generator sample, then a generator update against the updated
discriminator, on one device, in float32.

A copy of the served trainer's rules: the loss terms and their weights,
the optax-form optimizer (the global-norm clip that scales only at or
over its limit, the elementwise clip, Adam with eps outside the square
root and both bias corrections, the staircase learning-rate decay), all
written out as plain tensor arithmetic: no fused kernels, no sharding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .audio.stft import mel_spectrogram
from .core.masking import slice_segments
from .train import losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4
    betas: tuple = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875
    steps_per_epoch: int = 1
    c_mel: float = 45.0
    c_spec: Optional[float] = None
    c_kl: float = 1.0
    c_adv: float = 1.0
    c_fm: float = 1.0
    c_kl_rev: float = 0.05
    c_stft: float = 0.0
    c_energy: float = 10.0
    grad_clip: float = 500.0
    grad_clip_norm: float = 100.0
    use_mas: bool = True
    c_dc: float = 10.0


class Adam:
    """optax.chain(clip_by_global_norm, clip, adam(schedule)) over a list
    of parameters, updated in place."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = list(params)
        self.cfg = cfg
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.last_grads = None      # the gradients as the update got them

    def learning_rate(self) -> float:
        if self.count <= 0:
            return self.cfg.learning_rate
        return self.cfg.learning_rate * self.cfg.lr_decay ** math.floor(
            self.count / max(self.cfg.steps_per_epoch, 1))

    @torch.no_grad()
    def update(self, grads) -> None:
        c = self.cfg
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        scale = 1.0 if float(norm) < c.grad_clip_norm else \
            c.grad_clip_norm / float(norm)
        grads = [torch.clamp(g * scale, -c.grad_clip, c.grad_clip)
                 for g in grads]
        self.last_grads = grads
        lr = self.learning_rate()
        self.count += 1
        b1, b2 = c.betas
        t = self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + c.eps))


def gen_forward(gen, batch: dict, tc: TrainConfig, generator=None) -> dict:
    return gen(batch["phones"], batch["x_lengths"], batch["spec"],
               batch["y_lengths"], batch["note_ids"], batch["note_durations"],
               batch["f0_score"], batch["phone_durations"],
               batch["shengdiao"], deterministic=False, use_mas=tc.use_mas,
               log_f0=batch["log_f0"], generator=generator)


def slice_real_audio(audio, ids_slice, svs_cfg):
    return slice_segments(audio, ids_slice * svs_cfg.hop_length,
                          svs_cfg.segment_size)


def generator_loss(disc, out: dict, batch: dict, svs_cfg, tc: TrainConfig):
    audio = out["audio"]
    y_real = slice_real_audio(batch["audio"], out["ids_slice"], svs_cfg)
    _, d_fake, fmap_r, fmap_g = disc(y_real, audio)
    mel_real = mel_spectrogram(y_real[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    mel_fake = mel_spectrogram(audio[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    m = {}
    m["loss_mel"] = losses.l1_masked(mel_fake, mel_real) * tc.c_mel
    m["loss_kl"] = losses.kl_divergence(out["z_p"], out["logs_q"], out["m_p"],
                                        out["logs_p"], out["y_mask"]) * tc.c_kl
    m["loss_kl_rev"] = losses.gaussian_nll(
        out["z_hat"], out["m_q"].detach(), out["logs_q"].detach(),
        out["y_mask"]) * tc.c_kl_rev
    m["loss_dur"] = losses.duration_loss(
        out["duration_fraction"], batch["note_durations"],
        out["duration_targets"], svs_cfg.frame_seconds,
        out["x_mask"][..., 0])
    m["loss_f0"] = losses.f0_loss(out["log_f0"], batch["log_f0"],
                                  out["y_mask"][..., 0])
    m["loss_adv"] = losses.generator_adv_loss(d_fake) * tc.c_adv
    m["loss_fm"] = losses.feature_matching_loss(fmap_r, fmap_g) * tc.c_fm
    m["loss_dc"] = losses.batch_mean(
        torch.mean(audio[..., 0], dim=1) ** 2) * tc.c_dc
    m["loss_energy"] = losses.energy_loss(audio[..., 0],
                                          y_real[..., 0]) * tc.c_energy
    total = sum(m.values())
    c_spec = tc.c_spec if tc.c_spec is not None else tc.c_mel
    m["loss_spec"] = losses.l1_masked(out["spec_predict"], batch["spec"],
                                      out["y_mask"]) * c_spec
    total = total + m["loss_spec"]
    m["loss_gen"] = total
    return total, {k: v.detach() for k, v in m.items()}


def train_step(gen, disc, gen_opt: Adam, disc_opt: Adam, batch: dict,
               svs_cfg, tc: TrainConfig, generator=None) -> dict:
    """One GAN step, updating both models in place: the loss terms, the
    discriminator's loss and the generator's training outputs."""
    with torch.no_grad():
        gen_out = gen_forward(gen, batch, tc, generator)
    y_real = slice_real_audio(batch["audio"], gen_out["ids_slice"], svs_cfg)
    d_real, d_fake, _, _ = disc(y_real, gen_out["audio"].detach())
    d_loss = losses.discriminator_adv_loss(d_real, d_fake)
    disc_opt.update(torch.autograd.grad(d_loss, disc_opt.params,
                                        allow_unused=True))
    out = gen_forward(gen, batch, tc, generator)
    total, metrics = generator_loss(disc, out, batch, svs_cfg, tc)
    grads = torch.autograd.grad(total, gen_opt.params, allow_unused=True)
    gen_opt.update(grads)
    metrics["loss_disc"] = d_loss.detach()
    return {"metrics": metrics, "audio": out["audio"].detach(),
            "duration_targets": out["duration_targets"].detach()}
