"""Additive MIDI-to-audio renderer (the accompaniment of the v1_model
variant).

Twin of music_generation_tpu/audio/render.py, host numpy as there: the
reference rendered its TeleMelody MIDI with FluidSynth and a soundfont
that the repository does not hold, so each note is a stack of partials
with a program-dependent envelope (struck and decaying for piano-class
programs, a detuned bowed pair with vibrato for sustained ones). The
string vibrato scales the total phase, not the frequency, as in the JAX
package: a detune that grows with time (ROADMAP.md, Queue 3), kept so that
both packages render the same samples.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 22050

_PIANO_PARTIALS = (1.0, 0.62, 0.4, 0.26, 0.18, 0.12, 0.08, 0.05)
_STRING_PARTIALS = (1.0, 0.55, 0.38, 0.28, 0.2, 0.14, 0.1)
# piano inharmonicity: partial k sounds at k * f * sqrt(1 + B * k^2)
_PIANO_B = 3e-4
# string section: two voices detuned +/- this many cents, 5.5 Hz vibrato
# fading in over 0.25 s
_STRING_DETUNE_CENTS = 5.0
_STRING_VIBRATO_HZ = 5.5
_STRING_VIBRATO_CENTS = 18.0


def _is_sustained(program: int) -> bool:
    # GM: 40-55 strings/ensemble, 56-79 brass/reed/pipe, 16-23 organ
    return 16 <= program <= 23 or 40 <= program <= 79


def render_notes(starts: np.ndarray, ends: np.ndarray, pitches: np.ndarray,
                 velocities: np.ndarray, sustained: bool,
                 total_samples: int, sample_rate: int = SAMPLE_RATE,
                 chunk: int = 32) -> np.ndarray:
    """Render (start_s, end_s, midi_pitch, velocity 0..127) note arrays into
    a float32 waveform of ``total_samples``, ``chunk`` notes at a time."""
    out = np.zeros(total_samples, np.float64)
    if len(starts) == 0:
        return out.astype(np.float32)
    partials = _STRING_PARTIALS if sustained else _PIANO_PARTIALS
    release = 0.05 if sustained else 0.15
    attack = 0.03 if sustained else 0.005
    freqs = 440.0 * 2.0 ** ((np.asarray(pitches, np.float64) - 69.0) / 12.0)
    amps = np.asarray(velocities, np.float64) / 127.0
    for lo in range(0, len(starts), chunk):
        hi = min(lo + chunk, len(starts))
        s = np.asarray(starts[lo:hi], np.float64)
        e = np.asarray(ends[lo:hi], np.float64)
        f = freqs[lo:hi]
        a = amps[lo:hi]
        i0 = np.floor(s * sample_rate).astype(int)
        i1 = np.minimum(np.ceil((e + release) * sample_rate).astype(int),
                        total_samples)
        span = int(max((i1 - i0).max(initial=0), 1))
        t = (np.arange(span)[None, :] / sample_rate)   # [n_notes, span]
        note_len = (e - s)[:, None]
        active = t < note_len + release
        # attack ramp, then sustain, then a linear release after note-off
        env = np.minimum(t / attack, 1.0)
        env = env * np.where(t < note_len, 1.0,
                             np.maximum(1.0 - (t - note_len) / release, 0.0))
        wave = np.zeros_like(t * f[:, None])
        if sustained:
            det = 2.0 ** (_STRING_DETUNE_CENTS / 1200.0)
            vib = (_STRING_VIBRATO_CENTS / 1200.0 * np.log(2.0)
                   * np.minimum(t / 0.25, 1.0)
                   * np.sin(2 * np.pi * _STRING_VIBRATO_HZ * t))
            for k, pk in enumerate(partials, start=1):
                # the vibrato scales the total phase (the JAX package's
                # render, kept as it is)
                ph = 2 * np.pi * f[:, None] * k * t * (1.0 + vib)
                wave += pk * 0.5 * (np.sin(ph * det) + np.sin(ph / det))
        else:
            # stretched partials, the higher ones decaying faster
            tau = np.maximum(note_len, 0.3)
            for k, pk in enumerate(partials, start=1):
                stretch = k * np.sqrt(1.0 + _PIANO_B * k * k)
                decay = np.exp(-(1.2 + 0.55 * k) * t / tau)
                wave += pk * decay * np.sin(
                    2 * np.pi * f[:, None] * stretch * t)
        wave *= env * active * a[:, None]
        for j in range(hi - lo):
            n = min(span, total_samples - i0[j])
            if n > 0:
                out[i0[j]: i0[j] + n] += wave[j, :n]
    return out.astype(np.float32)


def render_tracks(tracks: list, tempo_bpm: float = 120.0,
                  ticks_per_beat: int = 480,
                  sample_rate: int = SAMPLE_RATE,
                  total_seconds: float | None = None,
                  tick_offset: int = 0,
                  gain: float = 0.2,
                  sec_per_tick: float | None = None) -> np.ndarray:
    """MIDI tracks (audio.midi Track/Note) -> a mono float32 waveform,
    peak-normalised to ``gain``. ``sec_per_tick`` overrides the
    tempo-derived tick length: the song pipeline passes 0.001, the clock of
    TeleMelody's durations (ticks / 1000 seconds)."""
    if sec_per_tick is None:
        sec_per_tick = 60.0 / tempo_bpm / ticks_per_beat
    end_s = 0.0
    for tr in tracks:
        for n in tr.notes:
            end_s = max(end_s, (n.end + tick_offset) * sec_per_tick)
    total = total_seconds if total_seconds is not None else end_s + 0.3
    total_samples = int(round(total * sample_rate))
    out = np.zeros(total_samples, np.float32)
    for tr in tracks:
        if not tr.notes:
            continue
        starts = np.asarray([(n.start + tick_offset) * sec_per_tick
                             for n in tr.notes])
        ends = np.asarray([(n.end + tick_offset) * sec_per_tick
                           for n in tr.notes])
        pitches = np.asarray([n.pitch for n in tr.notes])
        vels = np.asarray([min(max(n.velocity, 1), 127) for n in tr.notes])
        out += render_notes(starts, ends, pitches, vels,
                            _is_sustained(tr.program), total_samples,
                            sample_rate)
    peak = np.abs(out).max()
    if peak > 0:
        out = out / peak
    return (gain * out).astype(np.float32)
