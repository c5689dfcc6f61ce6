"""GAN trainer for VISinger: one train step, its optimizer, checkpoints.

Twin of music_generation_tpu/train/trainer.py on one device. A step is a
discriminator update on a fresh generator sample, then a generator update
against the updated discriminator, with the JAX package's loss terms and
metrics. The optimizer is optax's chain: its clips, schedule and
accumulation by hand around torch's fused Adam (``Optimizer``).
Checkpoints are ``torch.save`` files, ``step_<n>.pt``, under the JAX
package's rules: keep the newest ``keep_last`` plus the one with the
lowest ``loss_mel`` (``best.json``).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from typing import Optional

import torch
from torch import nn

from ..audio.stft import mel_spectrogram
from ..core.masking import slice_segments
from ..device import resolve_device
from ..models.svs import MultiPeriodDiscriminator, SVSConfig, VISinger
from . import losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, field for field (its comments give
    each default's reason). ``bf16_run`` and ``log_images`` are not ported
    yet and must stay False."""
    learning_rate: float = 2e-4
    betas: tuple = (0.8, 0.99)
    eps: float = 1e-9
    lr_decay: float = 0.999875          # per epoch of applied updates
    steps_per_epoch: int = 1
    c_mel: float = 45.0
    c_spec: Optional[float] = None      # None = c_mel
    c_kl: float = 1.0
    c_adv: float = 1.0                  # 0 also skips the discriminator
    c_fm: float = 1.0
    c_kl_rev: float = 0.05
    c_stft: float = 0.0
    c_energy: float = 10.0
    seed: int = 1234
    grad_clip: float = 500.0
    grad_clip_norm: float = 100.0
    warmup_steps: int = 0
    accumulate_grad_batches: int = 1
    bf16_run: bool = False
    use_mas: bool = False
    disc_lr_scale: float = 1.0
    c_dc: float = 10.0
    disc_input_noise: float = 0.0
    disc_loss_floor: float = 0.0
    log_images: bool = False


class Optimizer:
    """optax.chain(clip_by_global_norm, clip, adamw(schedule,
    weight_decay=0)), wrapped in optax.MultiSteps when
    ``accumulate_grad_batches`` > 1, updating ``params`` in place.

    - the global-norm clip scales by max_norm / norm only when norm >=
      max_norm (not clip_grad_norm_'s max_norm / (norm + 1e-6));
    - then an elementwise clip to +-grad_clip;
    - then torch's fused Adam, which has optax's form: eps outside the
      sqrt, the same bias correction, no weight decay;
    - the learning rate is a staircase exponential decay per epoch of
      applied updates, after a linear warmup from 0 when warmup_steps > 0
      (so the first update has rate 0);
    - with accumulation, gradients are averaged over k mini-steps (optax's
      running mean) and one update is applied every k-th call.
    """

    def __init__(self, params, cfg: TrainConfig, lr_scale: float = 1.0):
        self.params = [p for p in params]
        self.cfg = cfg
        self.peak_lr = cfg.learning_rate * lr_scale
        self.updates_per_epoch = max(
            cfg.steps_per_epoch // max(cfg.accumulate_grad_batches, 1), 1)
        self.count = 0          # applied updates
        self.mini_step = 0
        self.adam = torch.optim.Adam(self.params, lr=self.peak_lr,
                                     betas=tuple(cfg.betas), eps=cfg.eps,
                                     fused=True)
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accumulate_grad_batches > 1 else None)

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` applied updates."""
        cfg, peak = self.cfg, self.peak_lr
        if cfg.warmup_steps > 0:
            if count < cfg.warmup_steps:
                return -peak * (1.0 - count / cfg.warmup_steps) + peak
            count -= cfg.warmup_steps
        if count <= 0:
            return peak
        epochs = math.floor(count / self.updates_per_epoch)
        return peak * cfg.lr_decay ** epochs

    @torch.no_grad()
    def update(self, grads) -> None:
        """Take one mini-step's gradients (an update every
        ``accumulate_grad_batches``-th call)."""
        cfg = self.cfg
        grads = list(grads)
        if self.acc is not None:
            k = cfg.accumulate_grad_batches
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % k
            if self.mini_step:
                return
            grads = self.acc
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < cfg.grad_clip_norm, torch.ones_like(norm),
                            cfg.grad_clip_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        torch._foreach_clamp_min_(grads, -cfg.grad_clip)
        torch._foreach_clamp_max_(grads, cfg.grad_clip)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self.adam.param_groups[0]["lr"] = self.learning_rate(self.count)
        self.count += 1
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "adam": self.adam.state_dict(), "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        if (self.acc is None) != (state["acc"] is None):
            raise ValueError("optimizer state 'acc' does not match this "
                             "accumulate_grad_batches")
        self.count, self.mini_step = state["count"], state["mini_step"]
        self.adam.load_state_dict(state["adam"])
        for dst, src in zip(self.acc or (), state["acc"] or ()):
            dst.copy_(src)


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer and its step count (calls of
    apply_gradients, as flax's TrainState.step)."""
    model: nn.Module
    opt: Optimizer
    step: int = 0

    def apply_gradients(self, grads) -> None:
        self.opt.update(grads)
        self.step += 1


def create_states(svs_cfg: SVSConfig, train_cfg: TrainConfig, device=None
                  ) -> tuple[TrainState, TrainState]:
    """Generator and discriminator states, weights from ``train_cfg.seed``
    (the global torch RNG is left as it was), on ``device``: cuda unless
    the caller asks for another; no GPU raises (see device.py)."""
    device = resolve_device(device)
    if train_cfg.bf16_run or train_cfg.log_images:
        raise NotImplementedError("bf16_run and log_images are not yet "
                                  "ported")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(train_cfg.seed)
        gen = VISinger(svs_cfg)
        disc = MultiPeriodDiscriminator()
    gen.to(device)
    disc.to(device)
    return (TrainState(gen, Optimizer(gen.parameters(), train_cfg)),
            TrainState(disc, Optimizer(disc.parameters(), train_cfg,
                                       lr_scale=train_cfg.disc_lr_scale)))


def gen_forward(gen: VISinger, batch: dict, train_cfg: TrainConfig,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None, **draws) -> dict:
    """The training forward on a batch of tensors (``draws``: the noise,
    noise_rev and slice_u of VISinger.forward)."""
    return gen(batch["phones"], batch["x_lengths"], batch["spec"],
               batch["y_lengths"], batch["note_ids"], batch["note_durations"],
               batch["f0_score"], batch["phone_durations"],
               batch["shengdiao"], deterministic=deterministic,
               use_mas=train_cfg.use_mas, generator=generator, **draws)


def slice_real_audio(audio: torch.Tensor, ids_slice: torch.Tensor,
                     svs_cfg: SVSConfig) -> torch.Tensor:
    return slice_segments(audio, ids_slice * svs_cfg.hop_length,
                          svs_cfg.segment_size)


def disc_apply(disc: MultiPeriodDiscriminator, y_real, y_fake,
               train_cfg: TrainConfig,
               generator: Optional[torch.Generator] = None):
    """The discriminator on real and generated segments, with instance
    noise on both when ``disc_input_noise`` > 0."""
    s = train_cfg.disc_input_noise
    if s > 0.0:
        y_real = y_real + s * torch.randn(y_real.shape, generator=generator,
                                          device=y_real.device)
        y_fake = y_fake + s * torch.randn(y_fake.shape, generator=generator,
                                          device=y_fake.device)
    return disc(y_real, y_fake)


def discriminator_loss(disc, gen_out: dict, batch: dict, svs_cfg: SVSConfig,
                       train_cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None):
    y_real = slice_real_audio(batch["audio"], gen_out["ids_slice"], svs_cfg)
    d_real, d_fake, _, _ = disc_apply(disc, y_real, gen_out["audio"].detach(),
                                      train_cfg, generator)
    return losses.discriminator_adv_loss(d_real, d_fake)


def generator_loss(disc, out: dict, batch: dict, svs_cfg: SVSConfig,
                   train_cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None):
    """(total, metrics) of the generator step: every loss term and metric
    of the JAX package's gen_loss_fn, summed in its order."""
    tc = train_cfg
    audio = out["audio"]
    y_real = slice_real_audio(batch["audio"], out["ids_slice"], svs_cfg)
    _, d_fake, fmap_r, fmap_g = disc_apply(disc, y_real, audio, tc,
                                           generator)
    mel_real = mel_spectrogram(y_real[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    mel_fake = mel_spectrogram(audio[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    m = {}
    m["loss_mel"] = losses.l1_masked(mel_fake, mel_real) * tc.c_mel
    m["loss_kl"] = losses.kl_divergence(out["z_p"], out["logs_q"], out["m_p"],
                                        out["logs_p"], out["y_mask"]) * tc.c_kl
    # the posterior stats are detached: see the JAX package's gen_loss_fn
    m["loss_kl_rev"] = losses.gaussian_nll(
        out["z_hat"], out["m_q"].detach(), out["logs_q"].detach(),
        out["y_mask"]) * tc.c_kl_rev
    m["loss_dur"] = losses.duration_loss(
        out["duration_fraction"], batch["note_durations"],
        out["duration_targets"], svs_cfg.frame_seconds, out["x_mask"][..., 0])
    m["loss_f0"] = losses.f0_loss(out["log_f0"], batch["log_f0"],
                                  out["y_mask"][..., 0])
    m["loss_adv"] = losses.generator_adv_loss(d_fake) * tc.c_adv
    m["loss_fm"] = losses.feature_matching_loss(fmap_r, fmap_g) * tc.c_fm
    m["loss_dc"] = torch.mean(torch.mean(audio[..., 0], dim=1) ** 2) * tc.c_dc
    m["loss_energy"] = losses.energy_loss(audio[..., 0],
                                          y_real[..., 0]) * tc.c_energy
    total = sum(m.values())
    if tc.c_stft > 0:
        m["loss_stft"] = losses.multires_stft_loss(
            audio[..., 0], y_real[..., 0]) * tc.c_stft
        total = total + m["loss_stft"]
    c_spec = tc.c_spec if tc.c_spec is not None else tc.c_mel
    m["loss_spec"] = losses.l1_masked(out["spec_predict"], batch["spec"],
                                      out["y_mask"]) * c_spec
    total = total + m["loss_spec"]
    m["loss_gen"] = total
    metrics = {k: v.detach() for k, v in m.items()}
    # tanh-saturation telemetry (see the JAX package's gen_loss_fn)
    metrics["audio_dc"] = audio.detach().mean()
    metrics["audio_sat_frac"] = (audio.detach().abs() > 0.95).float().mean()
    return total, metrics


def make_train_step(svs_cfg: SVSConfig, train_cfg: TrainConfig):
    """train_step(gen_state, disc_state, batch, generator) -> metrics: one
    GAN step on a batch of tensors, updating both states in place. The
    metrics are 0-dim tensors on the batch's device."""
    tc = train_cfg

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: dict, generator: Optional[torch.Generator] = None
                   ) -> dict:
        gen, disc = gen_state.model, disc_state.model
        if tc.c_adv == 0.0:
            # pure-regression phase: no discriminator update
            d_loss = torch.zeros((), device=batch["audio"].device)
        else:
            with torch.no_grad():
                gen_out = gen_forward(gen, batch, tc, generator=generator)
            d_loss = discriminator_loss(disc, gen_out, batch, svs_cfg, tc,
                                        generator)
            d_grads = torch.autograd.grad(d_loss, disc_state.opt.params)
            # freeze D (params, optimizer state, step) while its loss is
            # under the floor
            if tc.disc_loss_floor <= 0.0 or \
                    float(d_loss.detach()) >= tc.disc_loss_floor:
                disc_state.apply_gradients(d_grads)
        out = gen_forward(gen, batch, tc, generator=generator)
        total, metrics = generator_loss(disc, out, batch, svs_cfg, tc,
                                        generator)
        params = gen_state.opt.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        gen_state.apply_gradients(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)])
        metrics["loss_disc"] = d_loss.detach()
        return metrics

    return train_step


def save_checkpoint(path: str, gen_state: TrainState, disc_state: TrainState,
                    step: int, keep_last: Optional[int] = None,
                    metric: Optional[float] = None) -> str:
    """Write <path>/step_<step>.pt; then record ``metric`` in best.json if
    it is the lowest so far and keep only the newest ``keep_last``
    checkpoints plus the best one."""
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, f"step_{step}.pt")
    torch.save({"gen": gen_state.model.state_dict(),
                "gen_opt": gen_state.opt.state_dict(),
                "gen_step": gen_state.step,
                "disc": disc_state.model.state_dict(),
                "disc_opt": disc_state.opt.state_dict(),
                "disc_step": disc_state.step}, file)
    if metric is not None:
        _update_best_pointer(path, step, metric)
    if keep_last:
        prune_checkpoints(path, keep_last)
    return file


def _best_file(path: str) -> str:
    return os.path.join(path, "best.json")


def _update_best_pointer(path: str, step: int, metric: float) -> None:
    """Track the lowest-metric step in <path>/best.json."""
    f = _best_file(path)
    if os.path.exists(f):
        with open(f) as fh:
            if json.load(fh).get("metric", float("inf")) <= metric:
                return
    with open(f, "w") as fh:
        json.dump({"step": step, "metric": float(metric)}, fh)


def prune_checkpoints(path: str, keep_last: int) -> list:
    """Delete all but the newest ``keep_last`` step_*.pt files (and the
    best.json step). Returns the pruned step numbers."""
    steps = sorted(
        int(m.group(1)) for m in
        (re.fullmatch(r"step_(\d+)\.pt", os.path.basename(f))
         for f in glob.glob(os.path.join(path, "step_*.pt"))) if m)
    protect = set(steps[-keep_last:]) if keep_last > 0 else set()
    if os.path.exists(_best_file(path)):
        with open(_best_file(path)) as fh:
            protect.add(json.load(fh).get("step"))
    pruned = [s for s in steps if s not in protect]
    for s in pruned:
        os.remove(os.path.join(path, f"step_{s}.pt"))
    return pruned


def restore_checkpoint(file: str, gen_state: TrainState,
                       disc_state: TrainState) -> None:
    """Load a save_checkpoint file into both states in place."""
    ckpt = torch.load(file, map_location="cpu", weights_only=True)
    for state, key in ((gen_state, "gen"), (disc_state, "disc")):
        state.model.load_state_dict(ckpt[key])
        state.opt.load_state_dict(ckpt[f"{key}_opt"])
        state.step = ckpt[f"{key}_step"]
