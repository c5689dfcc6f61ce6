"""Spectrogram features in PyTorch (framing by unfold + torch.fft.rfft).

Twin of music_generation_tpu/audio/stft.py (VISinger/utils/utils.py:
385-432): reflect-pad (n_fft - hop) / 2, periodic Hann window, no centre
padding, magnitude sqrt(re^2 + im^2 + 1e-6); the Slaney mel filterbank
(librosa.filters.mel defaults, fmin 50, fmax 7600) in numpy, log-compressed
with clip(1e-5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window semantics)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = 22050, n_fft: int = 1024, n_mels: int = 80,
                   fmin: float = 50.0, fmax: float = 7600.0) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft//2+1]."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides, also when ``pad``
    reaches past the signal (numpy's and jnp.pad's repeated reflection,
    where F.pad requires pad < length)."""
    n = y.shape[-1]
    period = 2 * (n - 1)
    idx = torch.arange(-pad, n + pad, device=y.device).abs() % period
    idx = torch.where(idx >= n, period - idx, idx)
    return y[..., idx]


def frame_signal(y: torch.Tensor, frame_length: int, hop: int
                 ) -> torch.Tensor:
    """[B, S] -> [B, n_frames, frame_length], n_frames = 1 + (S -
    frame_length) // hop (no centre padding): a view by unfold."""
    return y.unfold(-1, frame_length, hop)


def spectrogram(y: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                win_length: int = 1024) -> torch.Tensor:
    """Linear magnitude spectrogram. y: [B, S] in [-1, 1].
    Returns [B, n_frames, n_fft//2+1]; n_frames = S // hop (after padding)."""
    y = reflect_pad(y, (n_fft - hop) // 2)
    frames = frame_signal(y, n_fft, hop)
    window = torch.from_numpy(hann_window(win_length)).to(y.device,
                                                           y.dtype)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)


def spec_to_mel(spec: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                n_mels: int = 80, fmin: float = 50.0,
                fmax: float = 7600.0) -> torch.Tensor:
    """Linear [B, F, n_freq] -> log-mel [B, F, n_mels]."""
    basis = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin,
                                            fmax)).to(spec.device, spec.dtype)
    return torch.log(torch.clamp(spec @ basis.T, min=1e-5))


def mel_spectrogram(y: torch.Tensor, sr: int = 22050, n_fft: int = 1024,
                    hop: int = 256, win_length: int = 1024, n_mels: int = 80,
                    fmin: float = 50.0, fmax: float = 7600.0) -> torch.Tensor:
    return spec_to_mel(spectrogram(y, n_fft, hop, win_length),
                       sr, n_fft, n_mels, fmin, fmax)
