"""WAV helpers (host-side, numpy + scipy).

Twin of normalize_int16 / concat_with_delay / write_wav_bytes /
streaming_wav_header in music_generation_tpu/audio/wav.py: the reference's
int16 normalize and concatenate conventions, and the header of a WAV
stream.
"""

from __future__ import annotations

import io
import struct

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


def streaming_wav_header(sample_rate: int = SAMPLE_RATE, channels: int = 1,
                         bits: int = 16) -> bytes:
    """WAV header for a stream of unknown length: the RIFF and data sizes
    are the 0xFFFFFFFF sentinel that players read as 'until the end of
    the stream' (a stream cannot seek back to patch them)."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])
