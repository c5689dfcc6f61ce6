"""Fused song synthesis: lyrics -> WAV with one device-to-host copy.

Twin of music_generation_tpu/pipeline/fused.py. The host does G2P and WAV
framing. Everything between is enqueued on the device without a host
sync: the whole-song melody (MelodyGenerator.song_tensors, previous-
sentence conditioning included), the duration formatting, the note-token
-> MIDI mapping, the phone-level expansion, VISinger.infer and the int16
peak normalisation. The request then reads (audio, mel_len, note ids)
back in one copy.

The same songs as SongSynthesizer.synthesize_song, within the JAX twin's
bound: per-phone durations are clamped to MAX_PHONE_SECONDS and the frames
to a bucket from 2 x 0.4 s (or 2 x the pinned seconds) per syllable, so a
melody that outruns that bound is cut short where the staged path is not.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.wav import concat_with_delay, write_wav_bytes
from ..frontend import midi_to_note, note_id
from ..models.melody import MelodyGenerator
from ..models.melody.api import SRC_LEN, _decode_bucket
from .synthesis import (FRAME_BUCKETS, PHONE_BUCKETS, SongResult, _bucket,
                        peak_int16, split_sentences)

MAX_PHONE_SECONDS = MelodyGenerator.MAX_PHONE_SECONDS


def _midi_table(note_dict) -> np.ndarray:
    """note-dictionary id -> SVS note-embedding id (octave-clamped MIDI);
    0 (rest) for the dictionary's non-pitch tokens."""
    table = np.zeros((note_dict.size,), np.int64)
    for i, tok in enumerate(note_dict.tokens):
        if tok.isdigit():
            table[i] = note_id(midi_to_note(int(tok)))
    return table


class FusedSongSynthesizer:
    """Drop-in for SongSynthesizer.synthesize_song over the same melody
    generator (MSE or SDP durations) and SVS synthesizers."""

    def __init__(self, melody: MelodyGenerator, synthesizers: dict,
                 lyric_replacements: tuple = ()):
        self.melody = melody
        self.synthesizers = synthesizers
        self.lyric_replacements = tuple(lyric_replacements)
        self._table = torch.from_numpy(_midi_table(melody.note_dict)).to(
            melody.device)

    def _durations(self, dur_raw: torch.Tensor, max_decode: int,
                   pinned: Optional[float]) -> torch.Tensor:
        """Seconds per syllable position [S, max_decode], float64, from the
        raw durations [S, SRC_LEN] of positions 1..max_decode (BOS first):
        the staged path's _format_durations on the device."""
        raw = F.pad(dur_raw, (0, max_decode + 1))[:, 1: max_decode + 1]
        raw = raw.double()
        if pinned is not None:
            d = torch.full_like(raw, pinned)
        elif self.melody.duration_variant == "mse":
            d = torch.round(raw) * 0.01
        else:
            d = torch.round(raw * 0.01, decimals=4)
            d = torch.where(d <= 0.15, 0.3201,
                            torch.where(d >= 2.0, 0.4305, d))
        return d.clamp(0.0, MAX_PHONE_SECONDS)

    @torch.no_grad()
    def synthesize_song(self, lyrics: str, singer_id: int = 0,
                        pinned_syllable_seconds: Optional[float] = None
                        ) -> SongResult:
        """``pinned_syllable_seconds`` replaces the duration head's output
        for every syllable (a benchmark's fixed workload)."""
        svs = self.synthesizers.get(singer_id, self.synthesizers[0])
        melody = self.melody
        sentences = split_sentences(lyrics,
                                    replacements=self.lyric_replacements)
        t_start = time.time()
        if not sentences:
            return SongResult(write_wav_bytes(concat_with_delay([])), [], [],
                              {"total_s": time.time() - t_start,
                               "device_s": 0.0})

        # --- host: G2P, index maps, one packed buffer ----------------------
        n = len(sentences)
        s_pad = 1 << (n - 1).bit_length()
        padded = sentences + [""] * (s_pad - n)
        max_len = max(len(s) for s in sentences)
        max_decode = _decode_bucket(max_len + 2)
        aligned = [svs.frontend.align_template(s + "AP") for s in sentences]
        t_pad = _bucket(max(len(a[0]) for a in aligned), PHONE_BUCKETS)
        lengths = [max(len(s), 1) for s in padded]
        # columns: lyric ids | phone ids | tone ids | syllable index |
        # phone count | lyric length
        c_ph, c_sd, c_si = SRC_LEN, SRC_LEN + t_pad, SRC_LEN + 2 * t_pad
        c_x = SRC_LEN + 3 * t_pad
        packed = np.zeros((s_pad, c_x + 2), np.int64)
        packed[:, :SRC_LEN] = np.concatenate(
            [melody._encode_src(s) for s in padded])
        packed[:, c_x] = 1
        packed[:, c_x + 1] = lengths
        for i, (phones, sheng, syl, _) in enumerate(aligned):
            t = len(phones)
            packed[i, c_ph: c_ph + t] = phones
            packed[i, c_sd: c_sd + t] = sheng
            packed[i, c_si: c_si + t] = np.minimum(syl, max_decode - 1)
            packed[i, c_x] = t
        per_syl = (2 * pinned_syllable_seconds if pinned_syllable_seconds
                   else 0.8)
        frame_bound = int(np.ceil(per_syl * (max_len + 1)
                                  / svs.cfg.frame_seconds)) + t_pad + 8
        max_frames = min(_bucket(frame_bound, FRAME_BUCKETS),
                         FRAME_BUCKETS[-1])

        # --- device: enqueued without a sync ---------------------------------
        buf = torch.from_numpy(packed)
        if melody.device.type == "cuda":
            buf = buf.pin_memory()
        buf = buf.to(melody.device, non_blocking=True)
        x_lengths, lens = buf[:, c_x], buf[:, c_x + 1]
        notes_all, dur_raw = melody.song_tensors(buf[:, :SRC_LEN], lengths,
                                                 max_decode)
        s_range = torch.arange(max_decode, device=buf.device)[None, :]
        in_lyric = s_range < lens[:, None]
        # the trailing AP syllable (s == length) sings a 0.6 s rest
        midi_sy = torch.where(in_lyric, self._table[notes_all], 0)
        dur_sy = torch.where(
            in_lyric, self._durations(dur_raw, max_decode,
                                      pinned_syllable_seconds),
            torch.where(s_range == lens[:, None], 0.6, 0.0)).float()
        syl = buf[:, c_si: c_si + t_pad]
        valid = (torch.arange(t_pad, device=buf.device)[None, :]
                 < x_lengths[:, None])
        audio, mel_len, _ = svs.model.infer(
            buf[:, c_ph: c_ph + t_pad], x_lengths,
            torch.where(valid, midi_sy.gather(1, syl), 0),
            torch.where(valid, dur_sy.gather(1, syl), 0.0),
            buf[:, c_sd: c_sd + t_pad], max_frames,
            generator=svs.generator)
        out = torch.cat([peak_int16(audio, mel_len, svs.cfg.hop_length),
                         mel_len.to(torch.int16)[:, None],
                         notes_all.to(torch.int16)], dim=1)
        # --- the one device-to-host copy --------------------------------------
        out = out.cpu().numpy()
        device_s = time.time() - t_start

        n_samples = max_frames * svs.cfg.hop_length
        mel_len = out[:, n_samples].astype(np.int64)
        wavs = [out[i, : mel_len[i] * svs.cfg.hop_length] for i in range(n)]
        all_notes = []
        for i, s in enumerate(sentences):
            toks = melody.note_dict.decode_ids(
                out[i, n_samples + 1: n_samples + 1 + len(s)].tolist())
            all_notes.append([midi_to_note(int(t)) if t.isdigit() else "rest"
                              for t in toks] + ["rest"])
        song = concat_with_delay(wavs, delay_seconds=0.2)
        return SongResult(
            wav_bytes=write_wav_bytes(song), lyrics_sentences=sentences,
            notes=all_notes,
            timings={"total_s": time.time() - t_start, "device_s": device_s},
            sentence_samples=[len(w) for w in wavs])
