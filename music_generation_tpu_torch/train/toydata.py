"""Synthetic "sine-singer" dataset for training demonstrations and tests.

Twin of music_generation_tpu/train/toydata.py: the same seed writes the
same transcriptions and WAV files.
The reference's training corpus (cpop) is not in the snapshot, so convergence
has to be demonstrated on self-generated data: each utterance is a random
note/phone score plus audio rendered as a harmonic stack that follows the
score's pitches and durations (with vibrato and per-phone amplitude
envelopes). The mapping score -> audio is deterministic and band-limited, so
a VISinger run on it must drive loss_mel down if the model/losses/optimizer
are wired correctly.

    python -m music_generation_tpu_torch.train.toydata OUT_DIR [--n 32]
        [--syllables 6] [--hop 256] [--sample-rate 22050] [--seed 0]
        [--voice bright|deep]

writes OUT_DIR/wavs, OUT_DIR/transcriptions.txt and the preprocessed
OUT_DIR/npy (train --data-dir OUT_DIR/npy; train.dataset's pack_dataset or
--pack makes the file train --packed reads).
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import preprocess_transcriptions

# pentatonic C major around C4
_TOY_NOTES = ("C4", "D4", "E4", "G4", "A4")

#: Voice profiles for the multispeaker axis (reference: three separately
#: trained voices dispatched by singer_id,
#: pipline_inference_svs_v6_multispeaker.py:166-171,232-239). Each voice is
#: (harmonic amplitudes, semitone shift of the AUDIO relative to the written
#: score). "bright" is the original single-voice render, bit-for-bit. "deep"
#: sings an octave below the written note with energy concentrated in the
#: fundamental — a timbrally dark, low-register voice; trained with
#: --f0-residual the model learns the -12 st register as a constant
#: deviation, so the served melody comes out an octave down (the YIN
#: preprocessing extracts F0 from the rendered audio, keeping the training
#: targets self-consistent).
VOICES = {
    "bright": {"harmonics": (0.6, 0.25, 0.1), "shift": 0},
    "deep": {"harmonics": (0.8, 0.12, 0.04), "shift": -12},
}
_TOY_SYLLABLES = ("ni", "hao", "shi", "jie", "tian", "di", "ren", "he")
_NOTE_HZ = {"C4": 261.63, "D4": 293.66, "E4": 329.63, "G4": 392.0,
            "A4": 440.0}
# phone split used by the score frontend (initials + finals)
_SYL_PHONES = {"ni": ("n", "i"), "hao": ("h", "ao"), "shi": ("sh", "i"),
               "jie": ("j", "ie"), "tian": ("t", "ian"), "di": ("d", "i"),
               "ren": ("r", "en"), "he": ("h", "e")}
_SYL_TEXT = {"ni": "你", "hao": "好", "shi": "世", "jie": "界", "tian": "天",
             "di": "地", "ren": "人", "he": "和"}


def _render_score(notes, durs, sample_rate: int,
                  voice: str = "bright") -> np.ndarray:
    """Harmonic stack following the note pitches, 5 Hz vibrato, per-note
    attack/decay envelope; harmonic weights and register come from the
    ``voice`` profile (VOICES)."""
    prof = VOICES[voice]
    amps, shift = prof["harmonics"], prof["shift"]
    total = int(sum(durs) * sample_rate)
    wav = np.zeros(total, np.float32)
    t0 = 0.0
    for note, dur in zip(notes, durs):
        n = int(dur * sample_rate)
        i0 = int(t0 * sample_rate)
        n = min(n, total - i0)
        if n <= 0:
            break
        t = np.arange(n) / sample_rate
        hz = _NOTE_HZ[note] * (2.0 ** (shift / 12.0))
        f0 = hz * (1.0 + 0.005 * np.sin(2 * np.pi * 5.0 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        seg = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
        env = np.minimum(t / 0.02, 1.0) * np.minimum((dur - t) / 0.05, 1.0)
        wav[i0: i0 + n] += (seg * np.clip(env, 0, 1)).astype(np.float32)
        t0 += dur
    return 0.8 * wav


def make_toy_dataset(out_dir: str, n_utts: int = 32, syllables: int = 6,
                     sample_rate: int = 22050, hop: int = 256,
                     seed: int = 0, voice: str = "bright") -> str:
    """Write wavs + transcriptions and preprocess them into ``out_dir``/npy.
    Returns the preprocessed directory path."""
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    npy_dir = os.path.join(out_dir, "npy")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    from ..audio.wav import write_wav
    for i in range(n_utts):
        syls = [str(rng.choice(_TOY_SYLLABLES)) for _ in range(syllables)]
        notes = [str(rng.choice(_TOY_NOTES)) for _ in range(syllables)]
        durs = rng.uniform(0.25, 0.5, syllables).round(2)
        wav = _render_score(notes, durs, sample_rate, voice=voice)
        name = f"toy{i:04d}"
        write_wav(os.path.join(wav_dir, f"{name}.wav"),
                  wav * 24000.0, sample_rate)
        text = "".join(_SYL_TEXT[s] for s in syls)
        phones, p_notes, p_ndurs, p_pdurs = [], [], [], []
        for syl, note, dur in zip(syls, notes, durs):
            sheng, yun = _SYL_PHONES[syl]
            tone = str(rng.randint(1, 5))
            phones += [sheng, yun + tone]  # tone marks the final only
            p_notes += [note, note]
            p_ndurs += [dur, dur]
            # initial gets a short slice of the note, final the rest
            head = min(0.08, float(dur) / 2)
            p_pdurs += [head, float(dur) - head]
        lines.append("|".join([
            name, text, " ".join(phones), " ".join(p_notes),
            " ".join(f"{d:.2f}" for d in p_ndurs),
            " ".join(f"{d:.4f}" for d in p_pdurs)]))
    trans = os.path.join(out_dir, "transcriptions.txt")
    with open(trans, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    preprocess_transcriptions(trans, npy_dir, wav_dir=wav_dir,
                              sample_rate=sample_rate, hop=hop)
    return npy_dir


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m music_generation_tpu_torch.train.toydata")
    p.add_argument("out_dir")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--syllables", type=int, default=6)
    p.add_argument("--hop", type=int, default=256)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--voice", default="bright", choices=sorted(VOICES),
                   help="voice profile (harmonics + register); train one "
                        "model per voice and serve them behind singer_id "
                        "for the multispeaker axis")
    args = p.parse_args(argv)
    npy = make_toy_dataset(args.out_dir, n_utts=args.n,
                           syllables=args.syllables, hop=args.hop,
                           sample_rate=args.sample_rate, seed=args.seed,
                           voice=args.voice)
    print(f"toy dataset -> {npy}")


if __name__ == "__main__":
    main()
