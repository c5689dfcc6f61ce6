"""Per-frame F0 extraction (YIN) for SVS training targets.

The reference trains VISinger on ground-truth per-frame F0
(``f0_score``/``log_f0`` consumed by models.py:557-620 via
utils/pitch_utils.py:22 f0_to_coarse); its preprocessing relied on external
librosa/parselmouth-class tooling that is absent here by design. This is a
self-contained vectorized YIN (de Cheveigné & Kawahara 2002): FFT-based
difference function, cumulative-mean normalization, absolute threshold with
local-minimum refinement and parabolic interpolation.

Twin of music_generation_tpu/audio/f0.py. Host-side numpy: F0 extraction
is an offline preprocessing step (train/dataset.py
preprocess_transcriptions), not part of the training step. Frames align
with the STFT used for the linear spectrogram (centered, hop =
SVSConfig.hop_length).
"""

from __future__ import annotations

import numpy as np


def _yin_prefilter(wav: np.ndarray, sample_rate: int,
                   lp_hz: float) -> np.ndarray:
    """Zero-phase brickwall low-pass ahead of the difference function.

    Vocoded audio can carry a strong near-Nyquist image of the fundamental
    (transposed-conv upsampler imaging; the mel loss stops at fmax=7600 so
    only the discriminator disciplines that band). Such a component makes
    the cmndf alternate between even and odd lags, and the dip search then
    locks onto the wrong parity ~0.5-1 semitone sharp even though the FFT
    fundamental is exact. F0 lives at 60-1000 Hz, so cutting above lp_hz
    keeps >= 4 harmonics of any trackable pitch while removing the trap."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    if lp_hz <= 0 or lp_hz >= sample_rate / 2 or len(wav) < 8:
        return wav
    spec = np.fft.rfft(wav)
    k = int(len(spec) * lp_hz / (sample_rate / 2))
    spec[k:] = 0.0
    return np.fft.irfft(spec, len(wav))


def yin_f0(wav: np.ndarray, sample_rate: int = 22050, hop: int = 256,
           frame_length: int = 2048, fmin: float = 60.0, fmax: float = 1000.0,
           threshold: float = 0.15, lp_hz: float = 4000.0) -> np.ndarray:
    """F0 in Hz per frame; 0.0 where unvoiced. Output length =
    1 + len(wav)//hop (matches a centered STFT's frame count)."""
    wav = _yin_prefilter(wav, sample_rate, lp_hz)
    n_frames = 1 + len(wav) // hop
    pad = frame_length // 2
    x = np.pad(wav, (pad, pad + frame_length))
    # frames: [n_frames, frame_length], frame i centered at i*hop
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(frame_length)[None, :])
    frames = x[idx]

    w = frame_length // 2           # correlation window
    tau_min = max(int(sample_rate / fmax), 1)
    tau_max = min(int(np.ceil(sample_rate / fmin)), w - 1)

    # difference function d(tau) = e0 + e(tau) - 2*r(tau) over window w
    fft_size = 2 * frame_length
    spec = np.fft.rfft(frames, fft_size, axis=1)
    # r(tau) = sum_{j<w} x[j] x[j+tau]: correlate frame with its first w
    # samples
    head = np.zeros_like(frames)
    head[:, :w] = frames[:, :w]
    r = np.fft.irfft(np.fft.rfft(head, fft_size, axis=1).conj() * spec,
                     axis=1)[:, : w]
    sq = frames ** 2
    cums = np.concatenate([np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)],
                          axis=1)
    e0 = cums[:, w] - cums[:, 0]                    # energy of x[0:w]
    taus = np.arange(w)
    e_tau = cums[:, taus + w] - cums[:, taus]       # energy of x[tau:tau+w]
    d = e0[:, None] + e_tau - 2.0 * r               # [n_frames, w]
    d = np.maximum(d, 0.0)

    # cumulative mean normalized difference
    csum = np.cumsum(d[:, 1:], axis=1)
    cmndf = np.ones_like(d)
    cmndf[:, 1:] = d[:, 1:] * np.arange(1, w) / np.maximum(csum, 1e-12)

    # absolute threshold: the dip is the contiguous under-threshold run
    # starting at the first crossing; pick its argmin. (A greedy
    # walk-while-decreasing stalls on the tiny cmndf ripples of real/vocoded
    # audio and lands at the crossing point, which sits systematically SHARP
    # of the dip bottom — measured ~+0.8 st on NSF vocoder output whose FFT
    # fundamental was exact.)
    band = cmndf[:, tau_min:tau_max]
    under = band < threshold
    voiced = under.any(axis=1)
    idx0 = under.argmax(axis=1)                      # first crossing
    falses = np.cumsum(~under, axis=1)
    cols = np.arange(band.shape[1])
    # j is in the run iff j >= idx0 and no False occurred in (idx0, j]
    run = ((cols[None, :] >= idx0[:, None])
           & (falses == falses[np.arange(n_frames), idx0][:, None]))
    dip_min = np.where(run, band, np.inf).argmin(axis=1)
    first = np.where(voiced, dip_min, band.argmin(axis=1)) + tau_min

    # parabolic interpolation around the chosen lag
    t0 = np.clip(first, 1, w - 2)
    ym = cmndf[np.arange(n_frames), t0 - 1]
    y0 = cmndf[np.arange(n_frames), t0]
    yp = cmndf[np.arange(n_frames), t0 + 1]
    denom = ym + yp - 2.0 * y0
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (ym - yp) / np.where(np.abs(denom) > 1e-12,
                                                denom, 1.0),
                     0.0)
    shift = np.clip(shift, -1.0, 1.0)
    tau = t0 + shift

    f0 = np.where(voiced, sample_rate / np.maximum(tau, 1e-6), 0.0)
    f0 = np.where((f0 >= fmin) & (f0 <= fmax), f0, 0.0)
    # silent frames are unvoiced regardless of the cmndf shape
    rms = np.sqrt(np.maximum(e0 / w, 0.0))
    f0 = np.where(rms > 1e-4, f0, 0.0)
    return f0.astype(np.float32)


def yin_f0_fast(wav: np.ndarray, sample_rate: int = 22050, hop: int = 256,
                **kw) -> np.ndarray:
    """yin_f0 through the native C++/OpenMP host code when it built (the
    preprocessing hot loop for real corpora; runtime/native/yin.cc is an
    algorithmic twin, parity-tested), numpy when the toolchain is
    missing."""
    from ..runtime.native_loader import native_available, yin_f0_native
    if native_available():
        return yin_f0_native(wav, sample_rate=sample_rate, hop=hop, **kw)
    return yin_f0(wav, sample_rate=sample_rate, hop=hop, **kw)


def f0_targets(wav: np.ndarray, sample_rate: int = 22050, hop: int = 256,
               **kw) -> tuple:
    """(log_f0, f0_score) training targets: log(1+f0) and the 256-bin coarse
    quantization the model's F0 embedding consumes
    (frontend/pitch.f0_to_coarse; parity VISinger/utils/pitch_utils.py:22)."""
    from ..frontend.pitch import f0_to_coarse
    f0 = yin_f0_fast(wav, sample_rate=sample_rate, hop=hop, **kw)
    log_f0 = np.log1p(f0).astype(np.float32)
    f0_score = f0_to_coarse(f0).astype(np.int32)
    return log_f0, f0_score
