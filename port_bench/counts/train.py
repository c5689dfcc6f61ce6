"""Operations of one GAN step, counted on the plain reference.

What a step needs: one generator forward with its gradients, the
discriminator's loss on that sample and its gradients, then every loss
term of the generator against the updated discriminator and the
generator's gradients. The program's second generator forward (a fresh
sample for the discriminator, without gradients) is not counted: one
forward can serve both updates. ``FlopCounterMode`` runs this at batch 1
on meta tensors. An item of ``T`` phones and ``F`` frames costs a
polynomial in (T, F) (terms of T, F, their squares and T x F: the
alignment score); the discriminators see fixed segments. Six runs fit it,
two more must agree to the operation. The optimizer's elementwise update
and the short-time Fourier transforms are not counted.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .svs import BASIS, _key

CHECK_AT = ((40, 300), (56, 420))


def _fit_points(segment_frames: int):
    f0 = max(segment_frames, 64) + 8
    return ((8, f0), (16, f0), (24, f0 + 32), (8, f0 + 96), (16, f0 + 192),
            (32, f0 + 128))


def one(sz: dict, t: int, f: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    from ..drivers.common import as_config
    from ..reference import train_step as ref
    from ..reference.models.svs import (MultiPeriodDiscriminator, SVSConfig,
                                        VISinger)
    meta = torch.device("meta")
    scfg = as_config(SVSConfig, sz["svs"])
    with meta:
        gen = VISinger(scfg)
        disc = MultiPeriodDiscriminator(tuple(sz["periods"]))
    hop = scfg.hop_length

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=meta)

    batch = {"phones": z(1, t, dtype=torch.int64),
             "x_lengths": torch.full((1,), t, device=meta),
             "spec": z(1, f, scfg.spec_channels),
             "y_lengths": torch.full((1,), f, device=meta),
             "note_ids": z(1, t, dtype=torch.int64),
             "note_durations": z(1, t), "f0_score": z(1, f, dtype=torch.int64),
             "phone_durations": z(1, t, dtype=torch.int32),
             "shengdiao": z(1, t, dtype=torch.int64),
             "audio": z(1, f * hop, 1), "log_f0": z(1, f)}
    tc = ref.TrainConfig()
    from ..reference.train import losses
    with FlopCounterMode(display=False) as counter:
        out = ref.gen_forward(gen, batch, tc)
        y_real = ref.slice_real_audio(batch["audio"], out["ids_slice"], scfg)
        d_real, d_fake, _, _ = disc(y_real, out["audio"].detach())
        d_loss = losses.discriminator_adv_loss(d_real, d_fake)
        torch.autograd.grad(d_loss, list(disc.parameters()))
        total, _ = ref.generator_loss(disc, out, batch, scfg, tc)
        torch.autograd.grad(total, list(gen.parameters()),
                            allow_unused=True)
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=4)
def coefficients(key: tuple) -> np.ndarray:
    sz = {"svs": dict(key[0]), "periods": list(key[1])}
    seg = sz["svs"]["segment_size"] // sz["svs"]["hop_length"]
    pts = _fit_points(seg)
    a = np.array([[b(t, f) for b in BASIS] for t, f in pts], np.float64)
    y = np.array([one(sz, t, f) for t, f in pts], np.float64)
    coef = np.linalg.solve(a, y)
    for t, f in CHECK_AT:
        f = max(f, pts[0][1])
        fit = sum(c * b(t, f) for c, b in zip(coef, BASIS))
        got = one(sz, t, f)
        if abs(fit - got) > 1e-6 * got:
            raise AssertionError(f"the step's operation count is not "
                                 f"polynomial at ({t}, {f}): {got} against "
                                 f"{fit}")
    return coef


def step_flops(sz: dict, items) -> float:
    """Operations of every item ``(phones, frames)`` in ``items``."""
    coef = coefficients((_key(sz["svs"]), tuple(sz["periods"])))
    return float(sum(sum(c * b(t, f) for c, b in zip(coef, BASIS))
                     for t, f in items))
