"""WAV helpers (host-side, numpy + scipy).

Twin of music_generation_tpu/audio/wav.py: the reference's int16
normalize, concatenate and mix conventions, WAV files and bytes, the header
of a WAV stream, and polyphase resampling.
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


def mix(accompaniment: np.ndarray, vocal: np.ndarray,
        accompaniment_gain: float = 0.8) -> np.ndarray:
    """The vocal over the accompaniment (the reference's 0.8 * accomp +
    vocal), renormalised to int16 full scale."""
    n = max(len(accompaniment), len(vocal))
    out = np.zeros(n, dtype=np.float64)
    out[: len(accompaniment)] += accompaniment_gain * np.asarray(
        accompaniment, np.float64)
    out[: len(vocal)] += np.asarray(vocal, np.float64)
    return normalize_int16(out / 32767.0) if out.size else out


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


def write_wav(path: str, wav: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> None:
    wavfile.write(path, sample_rate, np.asarray(wav).astype(np.int16))


def read_wav(path: str) -> tuple[int, np.ndarray]:
    return wavfile.read(path)


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling from ``sr_in`` to ``sr_out`` Hz."""
    if sr_in == sr_out:
        return np.asarray(wav)
    from math import gcd

    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    return resample_poly(np.asarray(wav, np.float64), sr_out // g, sr_in // g)
