"""GAN trainer for VISinger: one train step, its optimizer, checkpoints.

Twin of music_generation_tpu/train/trainer.py. A step is a
discriminator update on a fresh generator sample, then a generator update
against the updated discriminator, with the JAX package's loss terms and
metrics. The optimizer is optax's chain: its clips, schedule and
accumulation by hand around torch's fused Adam (``Optimizer``).
Checkpoints are ``torch.save`` files, ``step_<n>.pt``, under the JAX
package's rules: keep the newest ``keep_last`` plus the one with the
lowest ``loss_mel`` (``best.json``).

On several devices (one process each, parallel.StepMesh) a step is the
one-process step on the concatenated batch: every rank draws the global
noise and keeps its rows (core.draws), computes its share of each loss
(train.losses), and sums its gradients over the ranks before the update;
with ``n_model`` > 1 the large weights and their Adam moments are held as
shards over the model group and gathered at use (``distribute_states``).
The metrics are the global values, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import math
import os
import re
from typing import Optional

import torch
from torch import nn

from ..audio.stft import mel_spectrogram
from ..core import draws
from ..core.masking import slice_segments
from ..device import resolve_device
from ..models.svs import MultiPeriodDiscriminator, SVSConfig, VISinger
from . import losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, field for field (its comments give
    each default's reason). ``bf16_run`` computes the generator and the
    discriminator from bfloat16 casts of their float32 masters and of the
    batch (``bf16_call``). ``log_images`` adds the first item's mel and
    spectrogram predictions, spectrogram target and phone-to-frame
    alignment to each step's metrics, as device tensors (MetricsWriter
    renders them)."""
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


def clip_by_global_norm(grads: list, max_norm: float,
                        norm_fn=None) -> list:
    """optax.clip_by_global_norm: every gradient scaled by max_norm / norm
    when the global norm is >= max_norm (not clip_grad_norm_'s max_norm /
    (norm + 1e-6)), with no host sync. ``norm_fn(grads)`` replaces the
    norm (sharded gradients: the norm over every shard)."""
    norm = (norm_fn(grads) if norm_fn is not None else
            torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return torch._foreach_mul(grads, scale)


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
        self.lr_scale = lr_scale
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
        # the global norm of sharded gradients (distribute_states)
        self.norm_fn = None

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
        grads = clip_by_global_norm(grads, cfg.grad_clip_norm, self.norm_fn)
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
    apply_gradients, as flax's TrainState.step). ``shards``: the model's
    large weights held as this rank's shards (distribute_states)."""
    model: nn.Module
    opt: Optimizer
    step: int = 0
    shards: Optional[object] = None

    def apply_gradients(self, grads) -> None:
        self.opt.update(grads)
        self.step += 1


def create_states(svs_cfg: SVSConfig, train_cfg: TrainConfig, device=None
                  ) -> tuple[TrainState, TrainState]:
    """Generator and discriminator states, weights from ``train_cfg.seed``
    (the global torch RNG is left as it was), on ``device``: cuda unless
    the caller asks for another; no GPU raises (see device.py)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(train_cfg.seed)
        gen = VISinger(svs_cfg)
        disc = MultiPeriodDiscriminator()
    gen.to(device)
    disc.to(device)
    return (TrainState(gen, Optimizer(gen.parameters(), train_cfg)),
            TrainState(disc, Optimizer(disc.parameters(), train_cfg,
                                       lr_scale=train_cfg.disc_lr_scale)))


def _call_with(module: nn.Module, shards, *args, **kwargs):
    return torch.func.functional_call(module, shards.gather(), args, kwargs)


def cast_floats(tree, src: torch.dtype, dst: torch.dtype):
    """``tree`` (tensors in dicts, lists and tuples) with every ``src``
    tensor cast to ``dst``; anything else as it was."""
    if torch.is_tensor(tree):
        return tree.to(dst) if tree.dtype == src else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, src, dst) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, src, dst) for v in tree)
    return tree


def bf16_call(module: nn.Module, *args, shards=None, **kwargs):
    """``module(*args, **kwargs)`` computed from bfloat16 casts of its
    float32 parameters (the JAX trainer's bf16_run): the casts sit in the
    autograd graph, so gradients reach the float32 masters as float32;
    float32 outputs come back. The caller casts the inputs. Each layer
    takes its input's dtype (core.layers._at_dtype), so where an input is
    float32 the op runs in float32, as flax promotes a (float32, bfloat16)
    pair. ``shards`` (ShardedParams): their gathered full weights stand in
    for the module's placeholders."""
    params = dict(module.named_parameters())
    if shards is not None:
        params.update(shards.gather())
    params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
              for n, p in params.items()}
    out = torch.func.functional_call(module, params, args, kwargs)
    return cast_floats(out, torch.bfloat16, torch.float32)


def _module_call(module: nn.Module, train_cfg: TrainConfig, shards=None):
    if train_cfg.bf16_run:
        return functools.partial(bf16_call, module, shards=shards)
    if shards is not None:
        return functools.partial(_call_with, module, shards)
    return module


def gen_forward(gen: VISinger, batch: dict, train_cfg: TrainConfig,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None, shards=None,
                **injected) -> dict:
    """The training forward on a batch of tensors (``injected``: the noise,
    noise_rev and slice_u of VISinger.forward). The batch's log_f0 drives
    the NSF source of an ``nsf`` generator. Under ``bf16_run`` the
    batch's float32 tensors go in as bfloat16 (bf16_call); the draws stay
    float32, as the JAX package's in-graph draws are. ``shards``: the
    generator's sharded weights (TrainState.shards)."""
    call = _module_call(gen, train_cfg, shards)
    if train_cfg.bf16_run:
        batch = cast_floats(batch, torch.float32, torch.bfloat16)
    return call(batch["phones"], batch["x_lengths"], batch["spec"],
                batch["y_lengths"], batch["note_ids"], batch["note_durations"],
                batch["f0_score"], batch["phone_durations"],
                batch["shengdiao"], deterministic=deterministic,
                use_mas=train_cfg.use_mas, log_f0=batch["log_f0"],
                generator=generator, **injected)


def slice_real_audio(audio: torch.Tensor, ids_slice: torch.Tensor,
                     svs_cfg: SVSConfig) -> torch.Tensor:
    return slice_segments(audio, ids_slice * svs_cfg.hop_length,
                          svs_cfg.segment_size)


def disc_apply(disc: MultiPeriodDiscriminator, y_real, y_fake,
               train_cfg: TrainConfig,
               generator: Optional[torch.Generator] = None, shards=None):
    """The discriminator on real and generated segments, with instance
    noise on both when ``disc_input_noise`` > 0 (in bfloat16 under
    ``bf16_run``, float32 out)."""
    s = train_cfg.disc_input_noise
    if s > 0.0:
        y_real = y_real + s * draws.randn(y_real.shape, generator=generator,
                                          device=y_real.device)
        y_fake = y_fake + s * draws.randn(y_fake.shape, generator=generator,
                                          device=y_fake.device)
    if train_cfg.bf16_run:
        y_real, y_fake = y_real.to(torch.bfloat16), y_fake.to(torch.bfloat16)
    return _module_call(disc, train_cfg, shards)(y_real, y_fake)


def discriminator_loss(disc, gen_out: dict, batch: dict, svs_cfg: SVSConfig,
                       train_cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       mesh=None, shards=None):
    y_real = slice_real_audio(batch["audio"], gen_out["ids_slice"], svs_cfg)
    d_real, d_fake, _, _ = disc_apply(disc, y_real, gen_out["audio"].detach(),
                                      train_cfg, generator, shards)
    return losses.discriminator_adv_loss(d_real, d_fake, mesh)


def generator_loss(disc, out: dict, batch: dict, svs_cfg: SVSConfig,
                   train_cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None,
                   mesh=None, shards=None):
    """(total, metrics) of the generator step: every loss term and metric
    of the JAX package's gen_loss_fn, summed in its order. With a
    ``mesh`` each is this rank's share of the global value (train.losses);
    ``shards``: the discriminator's sharded weights."""
    tc = train_cfg
    audio = out["audio"]
    y_real = slice_real_audio(batch["audio"], out["ids_slice"], svs_cfg)
    _, d_fake, fmap_r, fmap_g = disc_apply(disc, y_real, audio, tc,
                                           generator, shards)
    mel_real = mel_spectrogram(y_real[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    mel_fake = mel_spectrogram(audio[..., 0], svs_cfg.sampling_rate,
                               hop=svs_cfg.hop_length)
    m = {}
    m["loss_mel"] = losses.l1_masked(mel_fake, mel_real, mesh=mesh) * tc.c_mel
    m["loss_kl"] = losses.kl_divergence(out["z_p"], out["logs_q"], out["m_p"],
                                        out["logs_p"], out["y_mask"],
                                        mesh) * tc.c_kl
    # the posterior stats are detached: see the JAX package's gen_loss_fn
    m["loss_kl_rev"] = losses.gaussian_nll(
        out["z_hat"], out["m_q"].detach(), out["logs_q"].detach(),
        out["y_mask"], mesh) * tc.c_kl_rev
    m["loss_dur"] = losses.duration_loss(
        out["duration_fraction"], batch["note_durations"],
        out["duration_targets"], svs_cfg.frame_seconds, out["x_mask"][..., 0],
        mesh)
    m["loss_f0"] = losses.f0_loss(out["log_f0"], batch["log_f0"],
                                  out["y_mask"][..., 0], mesh)
    m["loss_adv"] = losses.generator_adv_loss(d_fake, mesh) * tc.c_adv
    m["loss_fm"] = losses.feature_matching_loss(fmap_r, fmap_g,
                                                mesh) * tc.c_fm
    m["loss_dc"] = losses.batch_mean(
        torch.mean(audio[..., 0], dim=1) ** 2, mesh) * tc.c_dc
    m["loss_energy"] = losses.energy_loss(audio[..., 0], y_real[..., 0],
                                          mesh=mesh) * tc.c_energy
    total = sum(m.values())
    if tc.c_stft > 0:
        m["loss_stft"] = losses.multires_stft_loss(
            audio[..., 0], y_real[..., 0], mesh=mesh) * tc.c_stft
        total = total + m["loss_stft"]
    if svs_cfg.autoencoder:  # the plain VISinger predicts no spectrogram
        c_spec = tc.c_spec if tc.c_spec is not None else tc.c_mel
        m["loss_spec"] = losses.l1_masked(out["spec_predict"], batch["spec"],
                                          out["y_mask"], mesh) * c_spec
        total = total + m["loss_spec"]
    m["loss_gen"] = total
    metrics = {k: v.detach() for k, v in m.items()}
    # tanh-saturation telemetry (see the JAX package's gen_loss_fn)
    metrics["audio_dc"] = losses.batch_mean(audio.detach(), mesh)
    metrics["audio_sat_frac"] = losses.batch_mean(
        (audio.detach().abs() > 0.95).float(), mesh)
    if tc.log_images:
        metrics.update(debug_images(out, batch, svs_cfg))
    return total, metrics


def debug_images(out: dict, batch: dict, svs_cfg: SVSConfig) -> dict:
    """The first item's debug images, detached on the batch's device: the
    mel prediction [F, n_mels], in the AE variant the spectrogram
    prediction and target [F, spec_channels], and the phone-to-frame
    alignment [F, T] (parity: the reference's plot_alignment_to_numpy,
    VISinger/utils/plot.py:24-45) drawn from the durations that drove the
    length regulator, so under --durations mas it shows the learned
    alignment."""
    images = {"img_mel_predict": out["mel_predict"][0].detach()}
    if svs_cfg.autoencoder:
        images["img_spec_predict"] = out["spec_predict"][0].detach()
        images["img_spec_target"] = batch["spec"][0]
    tgt = out["duration_targets"][0].float()
    ends = torch.cumsum(tgt, dim=0)
    starts = ends - tgt
    t_idx = torch.arange(out["mel_predict"].shape[1], device=tgt.device,
                         dtype=torch.float32)[:, None]
    images["img_alignment"] = ((t_idx >= starts[None, :])
                               & (t_idx < ends[None, :])).float()
    return images


def make_train_step(svs_cfg: SVSConfig, train_cfg: TrainConfig, mesh=None):
    """train_step(gen_state, disc_state, batch, generator) -> metrics: one
    GAN step on a batch of tensors, updating both states in place. The
    metrics are 0-dim tensors on the batch's device (and, with
    ``log_images``, the debug_images tensors). With a ``mesh``
    (parallel.StepMesh) the batch is this rank's rows of the global batch
    and ``generator`` is seeded alike on every rank: the step draws the
    global noise and keeps its rows, takes its share of every loss, sums
    the gradients over the ranks and returns the global metrics."""
    tc = train_cfg

    def reduce(state: TrainState, grads) -> list:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(state.opt.params, grads)]
        if mesh is not None:
            grads = mesh.reduce_grads(grads, _sharded_mask(state))
        return grads

    def step(gen_state: TrainState, disc_state: TrainState, batch: dict,
             generator: Optional[torch.Generator]) -> dict:
        gen, disc = gen_state.model, disc_state.model
        if tc.c_adv == 0.0:
            # pure-regression phase: no discriminator update
            d_loss = torch.zeros((), device=batch["audio"].device)
        else:
            with torch.no_grad():
                gen_out = gen_forward(gen, batch, tc, generator=generator,
                                      shards=gen_state.shards)
            d_loss = discriminator_loss(disc, gen_out, batch, svs_cfg, tc,
                                        generator, mesh, disc_state.shards)
            d_grads = reduce(disc_state, torch.autograd.grad(
                d_loss, disc_state.opt.params))
            if mesh is not None:
                d_loss = mesh.sum(d_loss)
            # freeze D (params, optimizer state, step) while its loss is
            # under the floor
            if tc.disc_loss_floor <= 0.0 or \
                    float(d_loss.detach()) >= tc.disc_loss_floor:
                disc_state.apply_gradients(d_grads)
        out = gen_forward(gen, batch, tc, generator=generator,
                          shards=gen_state.shards)
        total, metrics = generator_loss(disc, out, batch, svs_cfg, tc,
                                        generator, mesh, disc_state.shards)
        grads = torch.autograd.grad(total, gen_state.opt.params,
                                    allow_unused=True)
        gen_state.apply_gradients(reduce(gen_state, grads))
        if mesh is not None:
            scalars = [k for k, v in metrics.items() if v.ndim == 0]
            summed = mesh.sum(torch.stack([metrics[k] for k in scalars]))
            metrics.update(zip(scalars, summed.unbind()))
        metrics["loss_disc"] = d_loss.detach()
        return metrics

    def train_step(gen_state: TrainState, disc_state: TrainState,
                   batch: dict, generator: Optional[torch.Generator] = None
                   ) -> dict:
        if mesh is None:
            return step(gen_state, disc_state, batch, generator)
        with draws.global_rows(mesh.world, mesh.rank):
            return step(gen_state, disc_state, batch, generator)

    return train_step


def _sharded_mask(state: TrainState) -> list:
    """Per optimizer parameter: is it a shard (TrainState.shards)?"""
    shards = state.shards
    return [shards is not None and name in shards
            for name, _ in state.model.named_parameters()]


def _sharded_norm(mesh, sharded: list):
    """The global norm of a gradient list whose ``sharded`` entries are
    shards over the model group: their squares summed over it, the
    replicated ones counted once."""

    def norm_fn(grads):
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        mask = torch.tensor(sharded, device=sq.device)
        return torch.sqrt(sq[~mask].sum() + mesh.sum_model(sq[mask].sum()))
    return norm_fn


def distribute_states(gen_state: TrainState, disc_state: TrainState,
                      mesh, min_size: int = 2 ** 16) -> None:
    """Hold both states' large weights as this rank's shards over the
    model group (parallel.ShardedParams; nothing with ``n_model`` 1), each
    optimizer rebuilt over the shards with its state cut to match: the
    moments and the accumulator of a shard are its block of the full
    ones (``min_size``: param_partition_spec's). Restore a checkpoint
    before, not after."""
    from ..parallel import shard_params
    if mesh.n_model == 1:
        return
    for state in (gen_state, disc_state):
        full = state.opt.state_dict()
        state.shards = shard_params(state.model, mesh.n_model,
                                    mesh.model_rank, mesh.model_group,
                                    min_size)
        params = [state.shards.shards.get(name, p)
                  for name, p in state.model.named_parameters()]
        opt = Optimizer(params, state.opt.cfg, state.opt.lr_scale)
        opt.norm_fn = _sharded_norm(mesh, _sharded_mask(state))
        opt.load_state_dict(_map_sharded(full, state, state.shards.block))
        state.opt = opt


def _map_sharded(opt_state: dict, state: TrainState, fn) -> dict:
    """An Optimizer.state_dict() of ``state``'s model with ``fn(name,
    tensor)`` applied to the moments and the accumulator of every sharded
    parameter (a copy: the live state is not touched)."""
    names = [n if n in state.shards else None
             for n, _ in state.model.named_parameters()]
    adam = dict(opt_state["adam"])
    adam["state"] = {i: ({k: fn(names[i], v) if k in ("exp_avg",
                                                     "exp_avg_sq") else v
                          for k, v in st.items()} if names[i] else st)
                     for i, st in adam["state"].items()}
    acc = opt_state["acc"]
    if acc is not None:
        acc = [fn(n, a) if n else a for a, n in zip(acc, names)]
    return {**opt_state, "adam": adam, "acc": acc}


def full_state_dicts(state: TrainState) -> tuple[dict, dict]:
    """(model state_dict, optimizer state_dict) as one device holds them:
    a sharded state's weights, moments and accumulator gathered over the
    model group (a collective: every rank of the group calls it)."""
    model_sd, opt_sd = state.model.state_dict(), state.opt.state_dict()
    if state.shards is None:
        return model_sd, opt_sd
    shards = state.shards
    with torch.no_grad():
        for name, full in shards.gather().items():
            model_sd[name] = full
    return model_sd, _map_sharded(opt_sd, state, shards.gather_full)


def save_checkpoint(path: str, gen_state: TrainState, disc_state: TrainState,
                    step: int, keep_last: Optional[int] = None,
                    metric: Optional[float] = None,
                    write: bool = True) -> str:
    """Write <path>/step_<step>.pt; then record ``metric`` in best.json if
    it is the lowest so far and keep only the newest ``keep_last``
    checkpoints plus the best one. Sharded states are gathered first, so
    the file is the one a single device writes; every rank calls it and
    only the one with ``write`` writes (the JAX package's process 0)."""
    (gen_sd, gen_opt), (disc_sd, disc_opt) = (full_state_dicts(gen_state),
                                              full_state_dicts(disc_state))
    file = os.path.join(path, f"step_{step}.pt")
    if not write:
        return file
    os.makedirs(path, exist_ok=True)
    torch.save({"gen": gen_sd, "gen_opt": gen_opt,
                "gen_step": gen_state.step,
                "disc": disc_sd, "disc_opt": disc_opt,
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
