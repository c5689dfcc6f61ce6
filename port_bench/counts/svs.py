"""Operations of VISinger's inference, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the reference's
matrix products, convolutions (transposed ones too) and attention, two
operations per multiply-add, while it runs on meta tensors at batch 1: no
memory, no time on the card. A sentence of ``T`` phones and ``F`` frames
costs a polynomial in (T, F): terms of T (the text encoder), of F (the
frame post-net, the flow, the spectrogram decoder, the vocoder) and the
squares of both (attention over phones and over frames). Six runs fit
its coefficients; two more must agree to the operation, or the count
refuses. Elementwise work is not counted.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BASIS = (lambda t, f: 1, lambda t, f: t, lambda t, f: t * t,
         lambda t, f: f, lambda t, f: f * f, lambda t, f: t * f)
FIT_AT = ((8, 64), (16, 64), (24, 96), (8, 160), (16, 256), (32, 192))
CHECK_AT = ((12, 128), (40, 320))


def frames_of(samples: int, hop: int) -> int:
    return samples // hop


def _model(svs: dict):
    from ..drivers.common import as_config
    from ..reference.models.svs import SVSConfig, VISinger
    with torch.device("meta"):
        return VISinger(as_config(SVSConfig, svs)).eval()


def one(model, t: int, f: int) -> int:
    """Operations of one sentence of ``t`` phones and ``f`` frames."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = torch.device("meta")
    ph_dur = torch.zeros((1, t), dtype=torch.int32, device=meta)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        hidden, _, aux = model.infer_hidden(
            torch.zeros((1, t), dtype=torch.int64, device=meta),
            torch.full((1,), t, device=meta),
            torch.zeros((1, t), dtype=torch.int64, device=meta),
            torch.zeros((1, t), device=meta),
            torch.zeros((1, t), dtype=torch.int64, device=meta), f,
            ph_dur=ph_dur,
            noise=torch.zeros((1, f, model.cfg.inter_channels),
                              device=meta))
        model.decoder(hidden)
        # infer_hidden skips the duration head when it is given the frames
        model.duration_predictor(
            torch.zeros((1, t, model.cfg.hidden_channels), device=meta),
            torch.ones((1, t, 1), device=meta))
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=4)
def coefficients(svs_items: tuple) -> np.ndarray:
    model = _model(dict(svs_items))
    a = np.array([[b(t, f) for b in BASIS] for t, f in FIT_AT], np.float64)
    y = np.array([one(model, t, f) for t, f in FIT_AT], np.float64)
    coef = np.linalg.solve(a, y)
    for t, f in CHECK_AT:
        fit = sum(c * b(t, f) for c, b in zip(coef, BASIS))
        got = one(model, t, f)
        if abs(fit - got) > 1e-6 * got:
            raise AssertionError(f"the operation count is not polynomial at "
                                 f"({t}, {f}): {got} against {fit}")
    return coef


def _key(svs: dict) -> tuple:
    return tuple(sorted((k, tuple(map(tuple, v)) if k ==
                         "resblock_dilation_sizes" else
                         (tuple(v) if isinstance(v, list) else v))
                        for k, v in svs.items()))


def infer_flops(svs: dict, lengths) -> float:
    """Operations of every (phones, frames) sentence in ``lengths``."""
    coef = coefficients(_key(svs))
    return float(sum(sum(c * b(t, f) for c, b in zip(coef, BASIS))
                     for t, f in lengths))
