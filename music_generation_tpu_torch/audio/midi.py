"""Minimal Standard MIDI File writer (type 1), dependency-free.

Twin of music_generation_tpu/audio/midi.py (host code): the melody, chord
and lyric tracks of the TeleMelody melody (models/melody/telemelody.py),
written where the reference used miditoolkit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Note:
    pitch: int        # MIDI note number
    start: int        # ticks
    end: int          # ticks
    velocity: int = 80


@dataclass
class Track:
    name: str = ""
    program: int = 0          # GM program (0 = piano, 40 = violin)
    channel: int = 0
    notes: list[Note] = field(default_factory=list)
    lyrics: list[tuple[int, str]] = field(default_factory=list)  # (tick, text)


def _varlen(n: int) -> bytes:
    out = [n & 0x7F]
    n >>= 7
    while n:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(out))


def _track_chunk(events: list[tuple[int, bytes]]) -> bytes:
    events.sort(key=lambda e: e[0])
    data = bytearray()
    last = 0
    for tick, payload in events:
        data += _varlen(tick - last) + payload
        last = tick
    data += _varlen(0) + b"\xff\x2f\x00"  # end of track
    return b"MTrk" + struct.pack(">I", len(data)) + bytes(data)


def write_midi_bytes(tracks: list[Track], tempo_bpm: float = 120.0,
                     ticks_per_beat: int = 480) -> bytes:
    """A type-1 file: a conductor track with the tempo, then one track per
    Track (name, program change, lyric events, note on/off)."""
    header = b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks) + 1,
                                   ticks_per_beat)
    usec_per_beat = int(60_000_000 / tempo_bpm)
    chunks = [_track_chunk([
        (0, b"\xff\x51\x03" + struct.pack(">I", usec_per_beat)[1:])])]
    for trk in tracks:
        events: list[tuple[int, bytes]] = []
        if trk.name:
            name = trk.name.encode("utf-8")
            events.append((0, b"\xff\x03" + _varlen(len(name)) + name))
        events.append((0, bytes([0xC0 | trk.channel, trk.program])))
        for tick, text in trk.lyrics:
            t = text.encode("utf-8")
            events.append((tick, b"\xff\x05" + _varlen(len(t)) + t))
        for n in trk.notes:
            events.append((n.start, bytes([0x90 | trk.channel, n.pitch & 0x7F,
                                           n.velocity & 0x7F])))
            events.append((n.end, bytes([0x80 | trk.channel,
                                         n.pitch & 0x7F, 0])))
        chunks.append(_track_chunk(events))
    return header + b"".join(chunks)


def write_midi(path: str, tracks: list[Track], tempo_bpm: float = 120.0,
               ticks_per_beat: int = 480) -> None:
    with open(path, "wb") as f:
        f.write(write_midi_bytes(tracks, tempo_bpm, ticks_per_beat))


def seconds_to_ticks(seconds: float, tempo_bpm: float = 120.0,
                     ticks_per_beat: int = 480) -> int:
    return int(round(seconds * tempo_bpm / 60.0 * ticks_per_beat))
