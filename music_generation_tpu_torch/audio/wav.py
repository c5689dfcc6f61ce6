"""WAV helpers (host-side, numpy + scipy).

Twin of normalize_int16 / concat_with_delay / write_wav_bytes in
music_generation_tpu/audio/wav.py: the reference's int16 normalize and
concatenate conventions.
"""

from __future__ import annotations

import io

import numpy as np
from scipy.io import wavfile

SAMPLE_RATE = 22050


def normalize_int16(wav: np.ndarray, headroom: float = 32767.0) -> np.ndarray:
    """Scale a float waveform to int16 full-scale (reference convention:
    w *= 32767 / max(0.01, |w|_max))."""
    wav = np.asarray(wav, dtype=np.float64)
    peak = max(0.01, float(np.max(np.abs(wav))) if wav.size else 0.01)
    return (wav * (headroom / peak)).astype(np.float64)


def concat_with_delay(wavs: list[np.ndarray], delay_seconds: float = 0.2,
                      sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Concatenate per-sentence waveforms with a leading silence pad."""
    pad = np.zeros(int(delay_seconds * sample_rate))
    return np.concatenate([pad] + [np.asarray(w).ravel() for w in wavs]) \
        if wavs else pad


def write_wav_bytes(wav: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """int16 mono WAV container bytes (the HTTP payload format)."""
    buf = io.BytesIO()
    wavfile.write(buf, sample_rate, np.asarray(wav).astype(np.int16))
    return buf.getvalue()
