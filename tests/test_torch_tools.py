"""The port's offline tools (tools/torch_*.py twins of the JAX package's)
end to end on the CPU at tiny size, and their scoring functions against
the JAX tools' on the same arrays.

A toy corpus (4 utterances of 2 syllables, hop 16) trains two tiny
trainer checkpoints (one step each, dataset and MAS durations); then
torch_eval_copy_synthesis, torch_eval_sung_song, torch_mas_vs_gt,
torch_multispeaker_demo (a tiny served pipeline from the exported
checkpoint, two singers over HTTP) and torch_e2e_trained_demo (--only e2e,
4 steps) each run and write their JSON keys. The scoring functions hold
against the JAX tools': voice_stats (imported from
tools/multispeaker_demo.py) on the same WAV bytes, and the copy-synthesis
mel-L1, its audible variant, the semitone F0 error and the in-tune
fraction against the JAX tools' formulas over the JAX package's
mel_spectrogram and yin_f0.
"""

import importlib.util
import io
import json
import os
import socket
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.audio.f0 import yin_f0 as j_yin
from music_generation_tpu.audio.stft import mel_spectrogram as j_mel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
COPY_KEYS = {"ckpt", "n_utts", "mel_l1_trained", "mel_l1_audible_trained",
             "mel_l1_random_init", "improvement_x",
             "f0_rmse_semitones_trained", "audio_dc", "audio_sat_frac",
             "rms_ratio_rec_vs_ref", "dc_railed", "rms_in_band"}
SUNG_KEYS = {"ckpt", "pinned_durations", "f0_mode", "n_notes",
             "n_tracked_notes", "note_rmse_semitones", "note_bias_semitones",
             "frac_notes_within_half_semitone", "frame_f0_rmse_semitones",
             "note"}


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(npy corpus dir, {"gt": step_1.pt, "mas": step_1.pt})."""
    from music_generation_tpu_torch.train.__main__ import main as train_main
    from music_generation_tpu_torch.train.toydata import make_toy_dataset
    root = tmp_path_factory.mktemp("toy")
    npy = make_toy_dataset(str(root / "toy"), n_utts=4, syllables=2, hop=16)
    ckpts = {}
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None  # its TF import costs 15 s
    try:
        for tag, durations in (("gt", "dataset"), ("mas", "mas")):
            ck = root / tag
            train_main(["--tiny", "--device", "cpu", "--steps", "1",
                        "--batch-size", "2", "--data-dir", npy,
                        "--durations", durations, "--prefetch", "0",
                        "--ckpt-dir", str(ck)])
            ckpts[tag] = str(ck / "step_1.pt")
    finally:
        if saved is None:
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    yield npy, ckpts
    for path in ckpts.values():  # the full discriminator's, 0.5 GB each
        os.remove(path)


def test_eval_copy_synthesis(trained, tmp_path):
    npy, ckpts = trained
    out = tmp_path / "copy.json"
    load_tool("torch_eval_copy_synthesis").main([
        "--ckpt", ckpts["gt"], "--data-dir", npy, "--tiny", "--n", "2",
        "--device", "cpu", "--noise-scale", "0", "--out", str(out),
        "--wav-out", str(tmp_path / "rec.wav")])
    row = json.load(open(out))
    assert set(row) == COPY_KEYS and row["n_utts"] == 2
    assert np.isfinite(row["mel_l1_trained"]) and row["mel_l1_trained"] > 0
    assert os.path.exists(tmp_path / "rec_target.wav")


def test_eval_sung_song(trained, tmp_path):
    _, ckpts = trained
    out = tmp_path / "sung.json"
    rows = load_tool("torch_eval_sung_song").main([
        "--ckpt", ckpts["mas"], "--tiny", "--device", "cpu", "--pinned",
        "--f0", "score", "--out", str(out), "--wav-out",
        str(tmp_path / "song.wav")])
    assert [json.load(open(out))] == rows
    assert set(rows[0]) == SUNG_KEYS and rows[0]["n_notes"] == 24
    assert rows[0]["pinned_durations"] and rows[0]["f0_mode"] == "score"
    assert os.path.exists(tmp_path / "song.wav")


def test_mas_vs_gt(trained, tmp_path):
    npy, ckpts = trained
    out = tmp_path / "mas_vs_gt.json"
    result = load_tool("torch_mas_vs_gt").main([
        "--gt-ckpt", ckpts["gt"], "--mas-ckpt", ckpts["mas"], "--data-dir",
        npy, "--tiny", "--n", "2", "--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == result
    assert set(result) == {"pairs", "mean_mas_over_gt_ratio",
                           "max_mas_over_gt_ratio",
                           "all_pairs_within_tolerance", "tolerance",
                           "summary", "gt_eval", "mas_eval"}
    pair = result["pairs"][0]
    assert pair["ratio"] == round(pair["mel_l1_mas"] / pair["mel_l1_gt"], 4)


def test_multispeaker_demo(trained, tmp_path):
    """Two singers over HTTP from one exported tiny trainer checkpoint
    (whose hop-16 tensors the tiny server's hop-256 singers keep at their
    own inits): the tool writes its JSON, then exits non-zero, since the
    voices are not an octave apart."""
    _, ckpts = trained
    served = tmp_path / "served"
    load_tool("torch_export_trained_svs").main([
        "--ckpt", ckpts["gt"], "--out", str(served), "--tiny",
        "--speakers", "0", "1"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "ms.json"
    with pytest.raises(SystemExit, match="NOT distinct"):
        load_tool("torch_multispeaker_demo").main([
            "--checkpoint-dir", str(served), "--tiny", "--device", "cpu",
            "--port", str(port), "--text", "你好世界", "--out", str(out),
            "--wav-prefix", str(tmp_path / "ms"), "--startup-timeout",
            "120", "--request-timeout", "120"])
    row = json.load(open(out))
    assert set(row) == {"text", "checkpoint_dir", "voices",
                        "register_gap_semitones",
                        "centroid_ratio_deep_over_bright", "voices_distinct"}
    for name in ("bright", "deep"):
        assert set(row["voices"][name]) == {"audio_s", "median_f0_hz",
                                            "spectral_centroid_hz", "rms",
                                            "wav"}
        assert os.path.exists(tmp_path / f"ms_{name}.wav")
    assert row["voices_distinct"] is False


def test_e2e_trained_demo(tmp_path):
    out = tmp_path / "e2e.json"
    report = load_tool("torch_e2e_trained_demo").main([
        "--only", "e2e", "--steps", "4", "--device", "cpu", "--out",
        str(out)])
    assert json.load(open(out)) == report
    assert set(report) == {"steps", "melody_note", "duration_mse", "e2e",
                           "wall_s"}
    assert set(report["melody_note"]) == {"first_loss", "final_loss",
                                          "heldout_accuracy",
                                          "random_baseline"}
    e2e = report["e2e"]
    assert e2e["n_sentences"] == 1 and e2e["wav_bytes"] > 1000
    assert 0.0 <= e2e["note_accuracy_vs_mapping"] <= 1.0


def test_voice_stats_match_jax():
    """voice_stats of the port tool and of tools/multispeaker_demo.py on
    the same WAV bytes (a two-tone int16 signal)."""
    from scipy.io import wavfile
    sr = 22050
    t = np.arange(int(0.8 * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(
        2 * np.pi * 660.0 * t)
    buf = io.BytesIO()
    wavfile.write(buf, sr, (x * 32767).astype(np.int16))
    wav = buf.getvalue()
    want = load_tool("multispeaker_demo").voice_stats(wav)
    assert load_tool("torch_multispeaker_demo").voice_stats(wav) == want


def test_scores_match_jax_formulas():
    """The copy-synthesis mel-L1 (raw and audible), the semitone F0 error
    and the sung-song note scores of the port tools against the JAX
    tools' formulas over the JAX package's mel_spectrogram and yin_f0, on
    the same arrays."""
    copy = load_tool("torch_eval_copy_synthesis")
    sung = load_tool("torch_eval_sung_song")
    from music_generation_tpu_torch.audio.stft import mel_spectrogram
    sr, hop = 22050, 256
    rng = np.random.RandomState(0)
    t = np.arange(2 * 40 * hop) / sr
    ref = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (220.0, 330.0)])
    rec = (ref * 0.8 + 0.01 * rng.randn(*ref.shape)).astype(np.float32)
    ref = ref.astype(np.float32)
    y_len = np.asarray([80, 55])
    mels = [mel_spectrogram(torch.as_tensor(a), sr, hop=hop).numpy()
            for a in (rec, ref)]
    j_mels = [np.asarray(j_mel(jnp.asarray(a), sr, hop=hop))
              for a in (rec, ref)]
    lo = float(np.log(1e-2))
    for floor in (None, lo):
        want_t, want_n = 0.0, 0
        for i in range(2):
            f = min(int(y_len[i]), j_mels[0].shape[1])
            a, b = j_mels[0][i, :f], j_mels[1][i, :f]
            if floor is not None:
                a, b = np.maximum(a, floor), np.maximum(b, floor)
            want_t += float(np.abs(a - b).sum())
            want_n += f * j_mels[0].shape[-1]
        got = copy.valid_mel_l1(*mels, y_len, floor=floor)
        assert abs(got - want_t / want_n) <= 1e-4 * abs(got), floor
    errs = []
    for i in range(2):
        n = min(int(y_len[i]) * hop, rec.shape[1])
        f_rec, f_ref = j_yin(rec[i, :n], sample_rate=sr, hop=hop), \
            j_yin(ref[i, :n], sample_rate=sr, hop=hop)
        m = min(len(f_rec), len(f_ref))
        v = (f_rec[:m] > 0) & (f_ref[:m] > 0)
        d = 12.0 * np.log2(f_rec[:m][v] / f_ref[:m][v])
        errs.append(float(np.sqrt(np.mean(d ** 2))))
    assert copy.f0_rmse_semitones(rec, ref, y_len, sr, hop) == round(
        float(np.mean(errs)), 3)
    # the sung-song scores of two sentences of YIN tracks
    tracks = [j_yin(ref[i], sample_rate=sr, hop=hop) for i in range(2)]
    bounds = [[(0, 40), (40, 80)], [(0, 30), (30, 55)]]
    notes = [["A3", "A3"], ["E4", "E4"]]
    hz = {"A3": 220.0, "E4": 329.63}
    sung.NOTE_HZ.update(hz)
    got = sung.score_song(tracks, bounds, notes)
    note_errs = []
    for f0, sb, sn in zip(tracks, bounds, notes):
        for (a, b), note in zip(sb, sn):
            seg = f0[a:b][3:-3]
            voiced = seg[seg > 0]
            note_errs.append(12.0 * np.log2(np.median(voiced) / hz[note]))
    valid = np.asarray(note_errs)
    assert got["n_notes"] == got["n_tracked_notes"] == 4
    assert got["note_rmse_semitones"] == round(
        float(np.sqrt(np.mean(valid ** 2))), 3)
    assert got["frac_notes_within_half_semitone"] == round(
        float(np.mean(np.abs(valid) <= 0.5)), 3)
