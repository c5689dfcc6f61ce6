"""Training batch schema and synthetic batches.

Twin of music_generation_tpu/train/data.py: the same numpy RandomState
sequence, so one seed gives the JAX package's batch (the spectrogram up to
float32 rounding of the FFT). Batches are dicts of numpy arrays;
``to_device`` moves one to a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.stft import spectrogram
from ..models.svs import SVSConfig

BATCH_KEYS = ("phones", "x_lengths", "spec", "y_lengths", "note_ids",
              "note_durations", "f0_score", "phone_durations", "shengdiao",
              "audio", "log_f0")


def synthetic_batch(cfg: SVSConfig, batch: int = 2, t_phones: int = 16,
                    t_frames: int = 64, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    n_samples = t_frames * cfg.hop_length
    audio = rng.uniform(-0.3, 0.3, (batch, n_samples, 1)).astype(np.float32)
    n_fft = 2 * (cfg.spec_channels - 1)
    spec = spectrogram(torch.from_numpy(audio[..., 0]), n_fft=n_fft,
                       hop=cfg.hop_length, win_length=n_fft).numpy()
    spec = spec[:, :t_frames]
    # integer phone durations that tile the frame axis
    base = t_frames // t_phones
    phone_durations = np.full((batch, t_phones), base, np.int32)
    phone_durations[:, -1] += t_frames - base * t_phones
    return {
        "phones": rng.randint(3, 60, (batch, t_phones)).astype(np.int32),
        "x_lengths": np.full((batch,), t_phones, np.int32),
        "spec": spec.astype(np.float32),
        "y_lengths": np.full((batch,), t_frames, np.int32),
        "note_ids": rng.randint(40, 80, (batch, t_phones)).astype(np.int32),
        "note_durations": (phone_durations * cfg.frame_seconds).astype(
            np.float32),
        "f0_score": rng.randint(1, 255, (batch, t_frames)).astype(np.int32),
        "phone_durations": phone_durations,
        "shengdiao": rng.randint(3, 250, (batch, t_phones)).astype(np.int32),
        "audio": audio,
        "log_f0": np.log(rng.uniform(80, 400, (batch, t_frames))
                         ).astype(np.float32),
    }


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; for a CUDA device through
    pinned memory, with the copies left asynchronous."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        v = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True)
    return out
