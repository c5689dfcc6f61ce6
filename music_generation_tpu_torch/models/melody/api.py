"""Host-level melody generation API, MSE and SDP duration variants.

Twin of MelodyGenerator in music_generation_tpu/models/melody/api.py
(generate_song with on-device previous-sentence conditioning and note
repair, _format_durations, MAX_PHONE_SECONDS, handle_durations). The
SDP variant draws its flow noise from a torch.Generator seeded with
seed + 1 (the JAX twin's noise key). The reference's host logic:
cross-sentence conditioning pads prev/src to 60 tokens, notes are fixed to
len(lyric), a trailing rest/0.6 s/AP is appended. The beam decode runs a
static number of steps (the JAX package's decode bucket) with finished
beams frozen, so both packages pick the same notes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import resolve_device
from .beam import beam_search
from .transformer import (MelodyConfig, MelodyTransformer, MSEDurationModel,
                          SDPDurationConfig, SDPDurationModel, causal_mask)
from .vocab import BOS_ID, EOS_ID, EOS_TOKEN, MelodyDictionary

SRC_LEN = 60          # reference rpad length (inference.py:100-101)
MAX_DECODE = 60
DECODE_BUCKETS = (12, 20, 32, 44, MAX_DECODE)
BEAM_SIZE = 3


def _decode_bucket(n: int) -> int:
    for b in DECODE_BUCKETS:
        if n <= b:
            return b
    return MAX_DECODE


def _pad_to(ids: list[int], n: int) -> list[int]:
    return (ids + [0] * n)[:n] if len(ids) < n else ids[:n]


def handle_notes(notes: list[str], target_len: int) -> list[str]:
    out = [n for n in notes if n != EOS_TOKEN]
    if not out:
        out = ["60"]  # degenerate fallback: middle C (reference would crash)
    while len(out) < target_len:
        out.append(out[-1])
    return out[:target_len]


def handle_durations(durations: list[float]) -> list[float]:
    """SDP-variant clamp (inference.py:129-140 of the reference)."""
    return [0.3201 if d <= 0.15 else (0.4305 if d >= 2 else d)
            for d in durations]


def repair(tokens: torch.Tensor, length: int) -> torch.Tensor:
    """On-device handle_notes: cut at the first EOS and fill every invalid
    slot (after the EOS, or a PAD before it) with the last valid token of
    the sequence (fallback: the first dictionary pitch, id 4), zero past
    ``length`` — the JAX package's repair, whose scan hands on its final
    carry."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    seen_eos = torch.cumsum((tokens == EOS_ID).to(torch.int32), 0) > 0
    valid = ~seen_eos & (tokens != 0)
    last_idx = torch.where(valid, pos, torch.full_like(pos, -1)).max()
    # a gather, not tokens[last_idx]: indexing by a 0-dim tensor reads it
    # on the host
    last = torch.where(last_idx >= 0,
                       tokens.gather(0, last_idx.clamp(min=0).view(1))[0],
                       torch.full_like(last_idx, 4))
    out = torch.where(valid, tokens, last)
    return torch.where(pos < length, out, torch.zeros_like(out))


def next_prev_ids(notes: torch.Tensor, length: int) -> torch.Tensor:
    """[BOS] + notes[:length] + [EOS], right-padded to SRC_LEN."""
    pos = torch.arange(SRC_LEN, device=notes.device)
    k = min(notes.shape[0], SRC_LEN - 1)
    shifted = torch.zeros(SRC_LEN, dtype=notes.dtype, device=notes.device)
    shifted[1: k + 1] = notes[:k]
    return torch.where(pos == 0, BOS_ID, torch.where(
        pos <= length, shifted,
        torch.where(pos == length + 1, EOS_ID, 0))).to(notes.dtype)


class MelodyGenerator:
    """lyric (chars) -> (lyrics+AP, midi-note strings, durations seconds)."""

    # sanity bound: a duration head can emit negative or huge values before
    # training; clamp each phone to [0, 2] s
    MAX_PHONE_SECONDS = 2.0

    def __init__(self, lyric_dictionary: MelodyDictionary,
                 note_dictionary: MelodyDictionary,
                 cfg: Optional[MelodyConfig] = None,
                 duration_variant: str = "mse",
                 sdp_cfg: Optional[SDPDurationConfig] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.lyric_dict = lyric_dictionary
        self.note_dict = note_dictionary
        self.cfg = cfg or MelodyConfig(src_vocab=lyric_dictionary.size,
                                       tgt_vocab=note_dictionary.size)
        self.duration_variant = duration_variant
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.note_model = MelodyTransformer(self.cfg)
            if duration_variant == "mse":
                self.duration_model = MSEDurationModel(self.cfg)
            elif duration_variant == "sdp":
                self.sdp_cfg = sdp_cfg or SDPDurationConfig(
                    src_vocab=lyric_dictionary.size)
                self.duration_model = SDPDurationModel(self.sdp_cfg)
                # the SDP's flow noise (the JAX twin's _noise_key)
                self.generator = torch.Generator(self.device).manual_seed(
                    seed + 1)
            else:
                raise ValueError(duration_variant)
        self.note_model.to(self.device).eval()
        self.duration_model.to(self.device).eval()

    def _encode_src(self, lyric: str) -> np.ndarray:
        ids = [BOS_ID] + self.lyric_dict.encode(lyric) + [EOS_ID]
        return np.asarray([_pad_to(ids, SRC_LEN)], np.int64)

    def _decode_sentence(self, src, prev_ids, prev_active: bool,
                         max_decode: int) -> torch.Tensor:
        model = self.note_model
        src_attn = (src != 0)[:, None, None, :].to(torch.int32)
        memory, mem_mask = model.prev_memory(src, src_attn, prev_ids[None],
                                             prev_active)
        memory = memory.repeat_interleave(BEAM_SIZE, dim=0)
        key_mask = mem_mask.repeat_interleave(BEAM_SIZE, dim=0)
        tgt_mask = causal_mask(max_decode + 1, device=self.device)

        def decode_logits(seqs, step):
            # causal attention: position `step` sees only seqs[:, :step+1]
            n = step + 1
            out = model.decode(memory, key_mask, seqs[:, :n],
                               tgt_mask[..., :n, :n])
            return model.logits(out[:, step])

        seq, _ = beam_search(decode_logits, max_decode, BEAM_SIZE, BOS_ID,
                             EOS_ID, device=self.device)
        return seq

    @torch.no_grad()
    def note_durations(self, src: torch.Tensor,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw durations (centi-seconds, pre-round) [S, SRC_LEN]. The SDP
        variant's ``noise`` [S, SRC_LEN, 2] replaces its draw from the
        generator."""
        mask = src != 0
        if self.duration_variant == "mse":
            out = self.duration_model(src,
                                      mask[:, None, None, :].to(torch.int32))
            return (torch.exp(out) - 1.0) * mask
        w = self.duration_model.infer_duration(src, noise=noise,
                                               generator=self.generator)
        return w * mask

    @torch.no_grad()
    def song_tensors(self, src_all: torch.Tensor, lengths: list[int],
                     max_decode: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole-song melody on the device, with no host sync: the
        counterpart of the JAX package's MelodyGenerator._song_impl.
        src_all: [S, SRC_LEN] lyric ids on the device (_encode_src rows);
        lengths: each sentence's lyric length (at least 1). Each sentence's
        beam decode sees the previous sentence's repaired notes. Returns
        (note ids [S, max_decode], repaired and zero past each length; raw
        durations [S, SRC_LEN], centiseconds before rounding)."""
        prev = torch.zeros(SRC_LEN, dtype=torch.int64, device=self.device)
        notes_all = []
        for k, length in enumerate(lengths):
            seq = self._decode_sentence(src_all[k: k + 1], prev, k > 0,
                                        max_decode)
            notes = repair(seq, length)
            prev = next_prev_ids(notes, length)
            notes_all.append(notes)
        return torch.stack(notes_all), self.note_durations(src_all)

    def generate_song(self, sentences: list[str]):
        """All sentences of a song. Returns a list of (lyric+'AP', note
        strings + ['rest'], durations + [0.6])."""
        if not sentences:
            return []
        src_np = np.concatenate([self._encode_src(s) for s in sentences])
        notes_ids, dur_raw = self.song_tensors(
            torch.from_numpy(src_np).to(self.device),
            [max(len(s), 1) for s in sentences],
            _decode_bucket(int(max(len(s) for s in sentences)) + 2))
        notes_ids = notes_ids.cpu().numpy()
        dur_raw = dur_raw.cpu().numpy()

        results = []
        for i, lyric in enumerate(sentences):
            n_chars = len(lyric)
            notes = self.note_dict.decode_ids(notes_ids[i, :n_chars].tolist())
            notes = handle_notes([n for n in notes if n not in
                                  ("<PAD>", EOS_TOKEN)], n_chars)
            durations = self._format_durations(dur_raw[i], src_np[i], n_chars)
            notes.append("rest")
            durations.append(0.6)
            results.append((lyric + "AP", notes, durations))
        return results

    def generate(self, lyric: str):
        """One sentence, with no previous-sentence conditioning (the JAX
        twin's generate at index 0). Returns (lyric+'AP', note strings +
        ['rest'], durations seconds + [0.6])."""
        return self.generate_song([lyric])[0]

    def _format_durations(self, dur_raw, src_row, n_chars: int) -> list[float]:
        if self.duration_variant == "sdp":
            durations = [round(float(d * 0.01), 4) for d in dur_raw.tolist()]
            durations = handle_durations(durations[1: n_chars + 1])
            return (durations + [0.3201] * n_chars)[: n_chars]
        vals = np.round(dur_raw).tolist()
        n_valid = int((src_row != 0).sum())
        vals = vals[1: n_valid - 1]
        durations = [round(min(max(d * 0.01, 0.0), self.MAX_PHONE_SECONDS), 4)
                     for d in vals]
        return (durations + [0.4] * n_chars)[: n_chars]
