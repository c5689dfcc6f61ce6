"""The plain glue of a batched score: the phone and frame buckets of a
batched call, one-sentence inference around the reference VISinger and
the int16 peak normalisation, copies of the served path's host rules.
Everything runs one sentence at a time, at batch 1, with no cache and no
batching.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from .core.masking import feature_mask

PHONE_BUCKETS = (16, 32, 48, 64, 96, 128)
FRAME_BUCKETS = (128, 256, 512, 768, 1024, 1536, 1984)


def bucket(value: int, buckets: tuple) -> int:
    i = bisect.bisect_left(buckets, value)
    if i < len(buckets):
        return buckets[i]
    return -(-value // 64) * 64


def score_frame_bound(score, frame_seconds: float) -> int:
    return (int(np.ceil(score.note_durations.sum() / frame_seconds))
            + len(score.phone_ids) + 8)


def batch_shape(scores: list, frame_seconds: float) -> tuple:
    """(phone pad, frame pad) of a batched call over ``scores``."""
    t_pad = bucket(max(len(s.phone_ids) for s in scores), PHONE_BUCKETS)
    bound = max(score_frame_bound(s, frame_seconds) for s in scores)
    return t_pad, min(bucket(bound, FRAME_BUCKETS), FRAME_BUCKETS[-1])


def score_tensors(score, t_pad: int, device) -> dict:
    n = len(score.phone_ids)

    def row(values, dtype):
        out = np.zeros((1, t_pad), dtype)
        out[0, :n] = values
        return torch.from_numpy(out).to(device)

    return {"phones": row(score.phone_ids, np.int64),
            "note_ids": row(score.note_ids, np.int64),
            "shengdiao": row(score.shengdiao_ids, np.int64),
            "note_durations": row(np.asarray(score.note_durations,
                                             np.float32), np.float32),
            "x_lengths": torch.tensor([max(n, 1)], device=device)}


@torch.no_grad()
def infer_sentence(model, score, t_pad: int, max_frames: int,
                   noise: torch.Tensor,
                   ph_dur: Optional[torch.Tensor] = None) -> dict:
    """One score through VISinger at batch 1, padded to (t_pad,
    max_frames), with the prior noise ``noise`` [1, max_frames, inter]
    and, when given, the frames per phone ``ph_dur`` [1, t_pad]: the
    hidden state, mel, F0, duration fractions, frames, the float audio
    and its int16 peak normalisation."""
    x = score_tensors(score, t_pad, noise.device)
    hidden, mel_len, aux = model.infer_hidden(
        x["phones"], x["x_lengths"], x["note_ids"], x["note_durations"],
        x["shengdiao"], max_frames, ph_dur=ph_dur, noise=noise)
    if ph_dur is not None:
        x_mask = feature_mask(x["x_lengths"], t_pad)
        aux["frac"] = model.duration_predictor(
            model.text_encoder(x["phones"], x["note_ids"],
                               x["note_durations"], x["shengdiao"], x_mask),
            x_mask)
    audio = model.decode_hidden(hidden, aux.get("exc"))
    hop = model.cfg.hop_length
    return {"hidden": hidden[0], "mel_len": int(mel_len[0]),
            "mel": aux["mel_predict"][0], "log_f0": aux["log_f0"][0],
            "frac": aux["frac"][0], "frames": aux["frames"][0],
            "int16": peak_int16(audio, mel_len, hop)[0]}


def peak_int16(audio: torch.Tensor, mel_len: torch.Tensor,
               hop: int) -> torch.Tensor:
    """[B, S, 1] float -> [B, S] int16 at 32767 / max(0.01, peak) over
    each item's valid samples, zero past them."""
    a = audio[..., 0]
    valid = (torch.arange(a.shape[1], device=a.device)[None, :]
             < (mel_len * hop)[:, None])
    a = a * valid
    peak = torch.clamp(a.abs().amax(dim=1, keepdim=True), min=0.01)
    return (a * (32767.0 / peak)).to(torch.int16)
