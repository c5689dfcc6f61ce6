#!/usr/bin/env python3
"""Copy-synthesis quality of trained VISinger checkpoints (the port's
trainer files), against the same model at random init.

Twin of tools/eval_copy_synthesis.py on the port: each ``step_<n>.pt``
(python -m music_generation_tpu_torch.train) is restored, its generator
reconstructs dataset utterances through VISinger.copy_synthesis
(spectrogram -> posterior -> waveform), and the tool reports the mel-L1
between reconstruction and ground truth over each utterance's valid
frames, for the trained and the random-init weights, the same with both
log-mels floored at log(1e-2) (the audible error), the YIN F0 error in
semitones, and the DC, saturation and loudness telemetry with the JAX
tool's verdicts. Same flags and JSON keys as the JAX tool, plus
``--device`` (default cuda).

Usage:
  python tools/torch_eval_copy_synthesis.py --ckpt ckpts/step_400.pt \
      --data-dir toyset/npy [--tiny] [--n 4] [--nsf] [--noise-scale 0] \
      [--out artifacts/torch_eval.json] [--dump rec.npz] [--wav-out rec.wav] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

AUDIBLE_FLOOR = float(np.log(1e-2))   # about -40 dB


def valid_mel_l1(mel_rec: np.ndarray, mel_ref: np.ndarray,
                 y_lengths, floor: float | None = None) -> float:
    """Mean |mel_rec - mel_ref| over each utterance's first y_lengths
    frames ([B, F, n_mels] log-mels), both floored at ``floor`` first when
    given (the JAX tool's "audible" variant)."""
    total, n = 0.0, 0
    for i in range(mel_rec.shape[0]):
        f = min(int(y_lengths[i]), mel_rec.shape[1])
        a, b = mel_rec[i, :f], mel_ref[i, :f]
        if floor is not None:
            a, b = np.maximum(a, floor), np.maximum(b, floor)
        total += float(np.abs(a - b).sum())
        n += f * mel_rec.shape[-1]
    return total / max(n, 1)


def f0_rmse_semitones(rec: np.ndarray, ref: np.ndarray, y_lengths,
                      sample_rate: int, hop: int):
    """Mean over utterances of the RMS semitone error between YIN F0 of
    the reconstruction and of the target over frames voiced in both
    (utterances with 4 such frames or fewer are skipped; None when none
    is left)."""
    from music_generation_tpu_torch.audio.f0 import yin_f0
    errs = []
    for i in range(rec.shape[0]):
        n = min(int(y_lengths[i]) * hop, rec.shape[1])
        f_rec = yin_f0(np.asarray(rec[i, :n], np.float32),
                       sample_rate=sample_rate, hop=hop)
        f_ref = yin_f0(np.asarray(ref[i, :n], np.float32),
                       sample_rate=sample_rate, hop=hop)
        m = min(len(f_rec), len(f_ref))
        voiced = (f_rec[:m] > 0) & (f_ref[:m] > 0)
        if voiced.sum() > 4:
            d = 12.0 * np.log2(f_rec[:m][voiced] / f_ref[:m][voiced])
            errs.append(float(np.sqrt(np.mean(d ** 2))))
    return round(float(np.mean(errs)), 3) if errs else None


def saturation(rec: np.ndarray, ref: np.ndarray) -> dict:
    """DC, saturated share and RMS ratio of the reconstruction, with the
    JAX tool's verdicts: dc_railed (|dc| > 0.5 or over half saturated) and
    rms_in_band (0.8 < ratio < 1.25, within about 2 dB)."""
    sat = {"audio_dc": round(float(rec.mean()), 4),
           "audio_sat_frac": round(float((np.abs(rec) > 0.95).mean()), 4),
           "rms_ratio_rec_vs_ref": round(
               float(np.sqrt((rec ** 2).mean())
                     / max(np.sqrt((ref ** 2).mean()), 1e-9)), 3)}
    sat["dc_railed"] = bool(abs(sat["audio_dc"]) > 0.5
                            or sat["audio_sat_frac"] > 0.5)
    sat["rms_in_band"] = bool(0.8 < sat["rms_ratio_rec_vs_ref"] < 1.25)
    return sat


def evaluate(ckpts: list, data_dir: str, tiny: bool = False, n: int = 4,
             nsf: bool = False, noise_scale: float = 1.0, device=None,
             dump: str | None = None, wav_out: str | None = None) -> list:
    """One result dict per checkpoint (the JAX tool's keys)."""
    import torch

    from music_generation_tpu_torch.audio.stft import mel_spectrogram
    from music_generation_tpu_torch.device import resolve_device
    from music_generation_tpu_torch.train import (TrainConfig,
                                                  build_svs_config,
                                                  create_states,
                                                  restore_checkpoint,
                                                  tool_shapes)
    from music_generation_tpu_torch.train.dataset import NpyDataset

    device = resolve_device(device)
    cfg = build_svs_config(tiny=tiny, nsf=nsf)
    t_phones, t_frames = tool_shapes(tiny)
    batch = NpyDataset(data_dir, cfg, t_phones=t_phones,
                       t_frames=t_frames).batch(n)
    spec = torch.as_tensor(batch["spec"], device=device)
    y_lengths = torch.as_tensor(batch["y_lengths"], device=device)
    log_f0 = torch.as_tensor(batch["log_f0"], device=device)
    ref_audio = np.asarray(batch["audio"])[..., 0]
    y_len = np.asarray(batch["y_lengths"])
    gen_state, disc_state = create_states(cfg, TrainConfig(), device)
    gen = gen_state.model.eval()
    random_params = {k: v.clone() for k, v in gen.state_dict().items()}

    @torch.no_grad()
    def reconstruct() -> np.ndarray:
        g = torch.Generator(device).manual_seed(0)
        noise = torch.randn((spec.shape[0], spec.shape[1],
                             cfg.inter_channels), generator=g,
                            device=device) * noise_scale
        audio, _, _ = gen.copy_synthesis(spec, y_lengths, noise=noise,
                                         log_f0=log_f0 if cfg.nsf else None)
        return audio[..., 0].float().cpu().numpy()

    def mel_l1():
        rec = reconstruct()
        ref = ref_audio[:, : rec.shape[1]]
        mels = [mel_spectrogram(torch.as_tensor(a), cfg.sampling_rate,
                                hop=cfg.hop_length).numpy()
                for a in (rec, ref)]
        return (valid_mel_l1(*mels, y_len), rec,
                valid_mel_l1(*mels, y_len, floor=AUDIBLE_FLOOR))

    random_l1, _, _ = mel_l1()
    results = []
    for k, ckpt in enumerate(ckpts):
        restore_checkpoint(os.path.abspath(ckpt), gen_state, disc_state)
        delta = sum(float((v.float() - random_params[name].float()).abs()
                          .sum()) for name, v in gen.state_dict().items())
        print(f"{ckpt}: restored param L1 delta vs random init: "
              f"{delta:.3e}")
        trained_l1, rec, trained_l1_floored = mel_l1()
        sat = saturation(rec, ref_audio[:, : rec.shape[1]])
        if sat["dc_railed"]:
            print("WARNING: reconstruction is DC-railed/saturated — the "
                  "mel-L1 and F0 numbers below are NOT valid quality "
                  "evidence", file=sys.stderr)
        if not sat["rms_in_band"]:
            print(f"WARNING: reconstruction loudness is off-target "
                  f"(rms_ratio {sat['rms_ratio_rec_vs_ref']}, band "
                  f"0.8-1.25) — quality numbers describe an audibly "
                  f"mis-leveled output", file=sys.stderr)
        result = {"ckpt": ckpt, "n_utts": n,
                  "mel_l1_trained": round(trained_l1, 4),
                  "mel_l1_audible_trained": round(trained_l1_floored, 4),
                  "mel_l1_random_init": round(random_l1, 4),
                  "improvement_x": round(random_l1 / max(trained_l1, 1e-9),
                                         2),
                  "f0_rmse_semitones_trained": f0_rmse_semitones(
                      rec, ref_audio, y_len, cfg.sampling_rate,
                      cfg.hop_length),
                  **sat}
        print(json.dumps(result))
        results.append(result)
        if k > 0:
            continue  # the wav and dump artifacts come from the first
        if dump:
            np.savez(dump, rec=rec, ref=ref_audio, y_lengths=y_len)
        if wav_out:
            from music_generation_tpu_torch.audio.wav import (
                normalize_int16, write_wav)
            n0 = min(int(y_len[0]) * cfg.hop_length, rec.shape[1])
            write_wav(wav_out, normalize_int16(rec[0, :n0] * 32767.0),
                      cfg.sampling_rate)
            base, ext = os.path.splitext(wav_out)
            write_wav(base + "_target" + ext,
                      normalize_int16(ref_audio[0, :n0] * 32767.0),
                      cfg.sampling_rate)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, nargs="+",
                   help="one or more trainer step_<n>.pt files; --wav-out "
                        "and --dump apply to the FIRST; --out holds a list "
                        "when several are given")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--dump", default=None,
                   help="save raw (unnormalized) rec/ref audio arrays to "
                        "this .npz")
    p.add_argument("--wav-out", default=None,
                   help="write the first reconstruction as a wav here")
    p.add_argument("--nsf", action="store_true",
                   help="checkpoint was trained with --nsf (the batch's "
                        "log-f0 drives the source)")
    p.add_argument("--noise-scale", type=float, default=1.0,
                   help="posterior sampling noise scale (0 = reconstruct "
                        "from the posterior mean)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    results = evaluate(args.ckpt, args.data_dir, args.tiny, args.n,
                       args.nsf, args.noise_scale, args.device, args.dump,
                       args.wav_out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results[0] if len(results) == 1 else results, f,
                      indent=1)
    return results


if __name__ == "__main__":
    main()
