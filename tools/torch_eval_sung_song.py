#!/usr/bin/env python3
"""Does a trained checkpoint of the port SING THE RIGHT NOTES, end to end?

Twin of tools/eval_sung_song.py on the port. Copy-synthesis
(tools/torch_eval_copy_synthesis.py) reconstructs from the ground-truth
spectrogram; this probe drives the full inference chain a served request
takes (score -> text encoder -> durations -> length regulator -> F0 ->
flow -> vocoder, VISinger.infer) over a four-sentence song of the toy
corpus' syllables and notes, then YIN-tracks each sentence against its
notes. Each note is scored over the exact frames the model gave its phones
(aux["frames"]), so duration drift never smears a note into its
neighbour's window; ``--pinned`` pins the per-phone frames from the score
instead, which isolates pitch from duration error.

Reported per run (edge frames dropped): each note's median-F0 error in
semitones, their RMSE and bias, the fraction of notes within 0.5 semitone
("in tune") and the frame-level RMSE. Same flags and JSON keys as the JAX
tool, plus ``--device`` (default cuda); ``--data-dir`` is accepted for the
JAX tool's command line and unused (the port's restore needs no example
batch). The frame count is capped at the text post-net's position table,
as the served path caps it, so a --tiny (hop 16) song is cut short and its
later notes count as untracked.

Usage:
  python tools/torch_eval_sung_song.py --ckpt ckpts/step_8000.pt [--nsf] \
      [--pinned] [--f0 score] [--sweep] [--out artifacts/torch_sung.json] \
      [--wav-out song.wav] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# a deterministic 4-sentence song over the toy corpus' syllables and
# pentatonic notes (train/toydata.py)
SONG = [
    ("你好世界天地", ["C4", "D4", "E4", "G4", "A4", "G4"]),
    ("天地人和你好", ["E4", "G4", "A4", "A4", "G4", "E4"]),
    ("世界人和天地", ["A4", "G4", "E4", "D4", "C4", "D4"]),
    ("你好天地世界", ["C4", "E4", "G4", "C4", "D4", "C4"]),
]
SYLLABLE_SECONDS = 0.4
NOTE_HZ = {"C4": 261.63, "D4": 293.66, "E4": 329.63, "G4": 392.0,
           "A4": 440.0}


def pinned_frames(syl_idx: np.ndarray, n_syl: int,
                  frames_per_note: int) -> np.ndarray:
    """Per-phone frames with every note exactly ``frames_per_note`` long,
    a syllable's frames split evenly over its phones (the first ones get
    the remainder)."""
    counts = np.bincount(syl_idx, minlength=n_syl)
    ph_dur = np.zeros(len(syl_idx), np.int32)
    pos = 0
    for s in range(n_syl):
        c = int(counts[s])
        base, rem = divmod(frames_per_note, c)
        for j in range(c):
            ph_dur[pos + j] = base + (1 if j < rem else 0)
        pos += c
    return ph_dur


def note_bounds(frames_ph: np.ndarray, syl_idx: np.ndarray, n_syl: int,
                n_frames: int) -> list:
    """(lo, hi) frame window of each note: the frames the model gave the
    note's phones, clipped to the sentence's frames."""
    bounds, pos = [], 0
    for s in range(n_syl):
        width = int(frames_ph[syl_idx == s].sum())
        bounds.append((min(pos, n_frames), min(pos + width, n_frames)))
        pos += width
    return bounds


def score_song(f0_tracks: list, bounds: list, notes: list) -> dict:
    """The JAX tool's scores of one song from each sentence's YIN track,
    its note windows and its note names: per-note median error in
    semitones over the window without 3 frames at each edge (a note with
    fewer than 4 voiced frames is untracked)."""
    note_errs, frame_errs = [], []
    in_tune = n_notes = 0
    for f0, sent_bounds, sent_notes in zip(f0_tracks, bounds, notes):
        for (lo, hi), note in zip(sent_bounds, sent_notes):
            seg = f0[lo:hi][3:-3]
            voiced = seg[seg > 0]
            n_notes += 1
            if len(voiced) < 4:
                note_errs.append(float("nan"))
                continue
            err = 12.0 * np.log2(np.median(voiced) / NOTE_HZ[note])
            note_errs.append(float(err))
            in_tune += abs(err) <= 0.5
            frame_errs.extend((12.0 * np.log2(voiced / NOTE_HZ[note]))
                              .tolist())
    valid = np.asarray([e for e in note_errs if np.isfinite(e)])
    return {
        "n_notes": n_notes,
        "n_tracked_notes": int(len(valid)),
        "note_rmse_semitones":
            round(float(np.sqrt(np.mean(valid ** 2))), 3) if len(valid)
            else None,
        "note_bias_semitones":
            round(float(np.mean(valid)), 3) if len(valid) else None,
        "frac_notes_within_half_semitone":
            round(in_tune / max(n_notes, 1), 3),
        "frame_f0_rmse_semitones":
            round(float(np.sqrt(np.mean(np.asarray(frame_errs) ** 2))), 3)
            if frame_errs else None,
    }


def synth_with_bounds(model, frontend, cfg, frames_per_note: int,
                      pinned: bool, device):
    """Each SONG sentence through ``model``.infer at one shared padded
    shape: (float32 waveforms, note windows per sentence)."""
    import torch

    from music_generation_tpu_torch.pipeline.synthesis import (FRAME_BUCKETS,
                                                               PHONE_BUCKETS,
                                                               _bucket)
    scores = [frontend.align(text, notes, [SYLLABLE_SECONDS] * len(notes))
              for text, notes in SONG]
    t_pad = _bucket(max(len(s.phone_ids) for s in scores), PHONE_BUCKETS)
    n_notes = max(len(n) for _, n in SONG)
    # capped at the position table, as the served path caps it: at hop 16
    # (--tiny) the song runs past it and its later notes go untracked
    max_frames = min(_bucket(n_notes * frames_per_note + 8, FRAME_BUCKETS),
                     FRAME_BUCKETS[-1])
    generator = torch.Generator(device).manual_seed(0)
    wavs, bounds = [], []
    for (text, _), score in zip(SONG, scores):
        _, _, syl_idx, n_syl = frontend.align_template(text)
        t = len(score.phone_ids)
        ph_dur = (pinned_frames(syl_idx, n_syl, frames_per_note) if pinned
                  else None)

        def pad(a, dtype):
            a = np.pad(np.asarray(a), (0, t_pad - t))
            return torch.as_tensor(a[None], dtype=dtype, device=device)

        with torch.no_grad():
            audio, mel_len, aux = model.infer(
                pad(score.phone_ids, torch.int64),
                torch.as_tensor([t], device=device),
                pad(score.note_ids, torch.int64),
                pad(score.note_durations, torch.float32),
                pad(score.shengdiao_ids, torch.int64), max_frames,
                ph_dur=None if ph_dur is None else pad(ph_dur, torch.int32),
                generator=generator)
        n_frames = int(mel_len[0])
        wavs.append(audio[0, :n_frames * cfg.hop_length, 0].float()
                    .cpu().numpy())
        bounds.append(note_bounds(aux["frames"][0, :t].cpu().numpy(),
                                  syl_idx, n_syl, n_frames))
    return wavs, bounds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="trainer step_<n>.pt")
    p.add_argument("--data-dir", default=None,
                   help="accepted for the JAX tool's command line; unused")
    p.add_argument("--nsf", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--decoder", default="hifigan",
                   choices=("hifigan", "istft", "mb_istft"),
                   help="must match the trainer's --decoder")
    p.add_argument("--pinned", action="store_true",
                   help="pin per-phone frames from the score")
    p.add_argument("--f0", default="predict", choices=("predict", "score"),
                   help="inference F0 source (SVSConfig.f0_mode)")
    p.add_argument("--sweep", action="store_true",
                   help="evaluate all four (pinned x f0 mode) combinations; "
                        "--out then holds a list and --wav-out the "
                        "free-running predict-mode song")
    p.add_argument("--f0-residual", action="store_true",
                   help="checkpoint was trained with --f0-residual")
    p.add_argument("--out", default=None)
    p.add_argument("--wav-out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import dataclasses

    from music_generation_tpu_torch.audio.f0 import yin_f0
    from music_generation_tpu_torch.device import resolve_device
    from music_generation_tpu_torch.frontend import ScoreFrontend
    from music_generation_tpu_torch.models.svs import VISinger
    from music_generation_tpu_torch.train import (TrainConfig,
                                                  build_svs_config,
                                                  create_states,
                                                  restore_checkpoint)

    device = resolve_device(args.device)
    try:
        cfg = build_svs_config(tiny=args.tiny, decoder=args.decoder,
                               nsf=args.nsf, f0_residual=args.f0_residual)
    except ValueError as e:
        p.error(str(e))
    gen_state, disc_state = create_states(cfg, TrainConfig(), device)
    restore_checkpoint(os.path.abspath(args.ckpt), gen_state, disc_state)
    weights = gen_state.model.state_dict()
    del gen_state, disc_state
    frontend = ScoreFrontend()
    frames_per_note = int(round(SYLLABLE_SECONDS * cfg.sampling_rate
                                / cfg.hop_length))
    combos = ([(False, "predict"), (True, "predict"), (False, "score"),
               (True, "score")] if args.sweep else [(args.pinned, args.f0)])
    results, wav_keep = [], None
    for pinned, f0_mode in combos:
        # f0_mode is an inference choice over the same weights
        model = VISinger(dataclasses.replace(cfg, f0_mode=f0_mode))
        model.load_state_dict(weights)
        model.to(device).eval()
        wavs, bounds = synth_with_bounds(model, frontend, cfg,
                                         frames_per_note, pinned, device)
        if wav_keep is None:
            wav_keep = wavs
        tracks = [yin_f0(w, sample_rate=cfg.sampling_rate,
                         hop=cfg.hop_length) for w in wavs]
        result = {
            "ckpt": args.ckpt,
            "pinned_durations": bool(pinned),
            "f0_mode": f0_mode,
            **score_song(tracks, bounds, [n for _, n in SONG]),
            "note": "full inference chain, not copy-synthesis; edge frames "
                    "dropped per note; note windows follow the model's own "
                    "per-phone frame counts (aux['frames'])",
        }
        print(json.dumps(result))
        results.append(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results if args.sweep else results[0], f, indent=1)
    if args.wav_out:
        from music_generation_tpu_torch.audio.wav import (concat_with_delay,
                                                          normalize_int16,
                                                          write_wav)
        song = concat_with_delay(wav_keep, 0.2)
        write_wav(args.wav_out, normalize_int16(song), cfg.sampling_rate)
    return results


if __name__ == "__main__":
    main()
