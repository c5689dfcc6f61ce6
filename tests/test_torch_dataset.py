"""The port's corpus readers against the JAX package's (CPU, tiny sizes).

Tolerances: every file and every integer field byte for byte; F0 fields
exactly, because both packages take the same YIN route here (the native
C++ twin, built from the same source with the same flags; asserted); a
batch's ``spec`` within 1e-5 relative L2 (two FFT implementations), every
other field of a batch exactly; native YIN against numpy YIN within
tests/test_f0.py's bounds (voicing agreement > 0.99, < 0.1 Hz where both
voice). The trainer CLI runs with its TensorBoard import blocked, as on a
machine without tensorboard; the writer's TensorBoard calls are held
against a recording stand-in.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from music_generation_tpu.models.svs import SVSConfig as JSVSConfig
from music_generation_tpu.ops import maximum_path_numpy
from music_generation_tpu.runtime import indexed_dataset as j_idx
from music_generation_tpu.runtime import native_loader as j_native
from music_generation_tpu.train import dataset as j_ds
from music_generation_tpu.train import toydata as j_toy
from music_generation_tpu_torch.audio import f0 as t_f0
from music_generation_tpu_torch.models.svs import SVSConfig
from music_generation_tpu_torch.ops import maximum_path_torch
from music_generation_tpu_torch.runtime import indexed_dataset as t_idx
from music_generation_tpu_torch.runtime import native_loader as t_native
from music_generation_tpu_torch.train import dataset as t_ds
from music_generation_tpu_torch.train import metrics as t_metrics
from music_generation_tpu_torch.train import toydata as t_toy
from music_generation_tpu_torch.train.__main__ import main as train_main
from torch_port_util import rel_err

TINY = dict(spec_channels=65, hop_length=16)
N_UTTS, SYLLABLES, HOP = 4, 2, 16
SR = 22050


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same toy corpus (4 utterances of 2 syllables, hop 16) written
    and preprocessed by each package, and each npy directory packed by
    its own package."""
    d = tmp_path_factory.mktemp("corpora")
    out = {}
    for tag, toy, ds in (("jax", j_toy, j_ds), ("port", t_toy, t_ds)):
        npy = toy.make_toy_dataset(str(d / tag), n_utts=N_UTTS,
                                   syllables=SYLLABLES, hop=HOP, seed=3)
        assert ds.pack_dataset(npy, str(d / f"{tag}_packed")) == N_UTTS
        out[tag] = (d / tag, npy, str(d / f"{tag}_packed"))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_quantize_phone_durations_matches_jax(seed):
    rng = np.random.RandomState(seed)
    durs = [float(x) for x in rng.uniform(0.001, 0.6, rng.randint(1, 40))
            .round(rng.randint(2, 5))]
    got = t_ds.quantize_phone_durations(durs)
    assert got == j_ds.quantize_phone_durations(durs)
    assert got == j_ds.quantize_phone_durations(durs, 0.0125)
    assert t_ds.quantize_phone_durations(durs, 0.01) == \
        j_ds.quantize_phone_durations(durs, 0.01)


def test_preprocessed_files_match_jax(corpora):
    """make_toy_dataset + preprocess_transcriptions: the transcriptions and
    WAVs byte for byte, every npy field equal. YIN route: native on both
    sides (asserted), so the F0 fields are compared exactly."""
    assert t_native.native_available() and j_native.native_available()
    (j_dir, j_npy, _), (t_dir, t_npy, _) = corpora["jax"], corpora["port"]
    assert (t_dir / "transcriptions.txt").read_bytes() == \
        (j_dir / "transcriptions.txt").read_bytes()
    wavs = sorted(os.listdir(j_dir / "wavs"))
    assert wavs == sorted(os.listdir(t_dir / "wavs")) and len(wavs) == N_UTTS
    for w in wavs:
        assert (t_dir / "wavs" / w).read_bytes() == \
            (j_dir / "wavs" / w).read_bytes()
    files = sorted(os.listdir(j_npy))
    assert files == sorted(os.listdir(t_npy))
    assert len(files) == N_UTTS * 8  # 5 score fields, wav, log-f0, f0-score
    for f in files:
        want = np.load(os.path.join(j_npy, f))
        got = np.load(os.path.join(t_npy, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    voiced = np.load(os.path.join(t_npy, "toy0000-f0-score.npy")) > 1
    assert voiced.mean() > 0.5


@pytest.mark.parametrize("route", ["native", "python"])
def test_indexed_dataset_matches_jax_both_ways(route, corpora, tmp_path,
                                               monkeypatch):
    """Both packages' packed files of one corpus are byte-identical, and
    each package's reader reads the other's file; on the native route and
    on the pure-Python one."""
    if route == "python":
        monkeypatch.setattr(t_idx, "_load", lambda: None)
    else:
        assert t_native.native_available()
    items = [{"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b": np.float32([1.5, -2.0]), "e": np.zeros((0, 4), np.int64),
              "u": np.frombuffer("名字".encode(), np.uint8)},
             {"x": np.float64(3.25).reshape(()), "m": np.bool_([1, 0, 1])},
             {}]
    for tag, mod in (("jax", j_idx), ("port", t_idx)):
        b = mod.IndexedDatasetBuilder(str(tmp_path / tag))
        assert [b.add_item(it) for it in items] == [0, 1, 2]
        b.finalize()
    for ext in ("data", "idx"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    for reader, writer in ((t_idx, "jax"), (j_idx, "port")):
        with reader.IndexedDataset(str(tmp_path / writer)) as ds:
            assert len(ds) == 3
            for got, want in ((ds[i], items[i]) for i in range(3)):
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
            batch = ds.read_batch([2, 0, 0])
            assert batch[0] == {} and set(batch[1]) == set(items[0])
    with t_idx.IndexedDataset(str(tmp_path / "port")) as ds:
        assert ds.native == (route == "native")
        with pytest.raises(IndexError):
            ds[3]
    assert t_idx.encode_item(items[0]) == j_idx.encode_item(items[0])
    (_, _, j_pack), (_, _, t_pack) = corpora["jax"], corpora["port"]
    for ext in ("data", "idx"):
        with open(f"{t_pack}.{ext}", "rb") as a, \
                open(f"{j_pack}.{ext}", "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("reader", ["npy", "packed"])
def test_batches_match_jax(reader, corpora):
    """NpyDataset / PackedDataset batches against the JAX package's for one
    seed (over the JAX package's own files, so the packed file is read
    across packages): every field equal, spec within 1e-5, three batches
    in a row; the packed batches equal the npy ones bit for bit."""
    _, j_npy, j_pack = corpora["jax"]
    src = j_npy if reader == "npy" else j_pack
    t_cls = t_ds.NpyDataset if reader == "npy" else t_ds.PackedDataset
    j_cls = j_ds.NpyDataset if reader == "npy" else j_ds.PackedDataset
    got_ds = t_cls(src, SVSConfig(**TINY), t_phones=8, t_frames=32, seed=7)
    want_ds = j_cls(src, JSVSConfig(**TINY), t_phones=8, t_frames=32, seed=7)
    npy_ds = t_ds.NpyDataset(j_npy, SVSConfig(**TINY), t_phones=8,
                             t_frames=32, seed=7)
    assert got_ds.names == want_ds.names and len(got_ds) == N_UTTS
    for _ in range(3):
        got, want = got_ds.batch(3), want_ds.batch(3)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            if k == "spec":  # two FFT implementations
                assert rel_err(got[k], want[k]) <= 1e-5
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ref = npy_ds.batch(3)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # utterances longer than t_frames are cut
    assert (got["y_lengths"] <= 32).all() and (got["x_lengths"] == 4).all()
    for ds in (got_ds, want_ds):
        if reader == "packed":
            ds.close()


def _harmonic(f0, seconds, seed):
    t = np.arange(int(SR * seconds)) / SR
    wav = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * t) for k in range(1, 5))
    wav += 0.01 * np.random.RandomState(seed).randn(len(t))
    return wav.astype(np.float32)


def test_yin_matches_jax_and_native():
    """The port's numpy YIN equals the JAX package's exactly; its native
    YIN agrees with numpy within tests/test_f0.py's bounds and equals the
    JAX package's native YIN; f0_targets equal the JAX package's."""
    from music_generation_tpu.audio import f0 as j_f0
    parts = [_harmonic(f, 0.3, i) for i, f in enumerate((110.0, 330.5))]
    wav = np.concatenate([np.zeros(SR // 8, np.float32)] + parts)
    ref = t_f0.yin_f0(wav, SR)
    np.testing.assert_array_equal(ref, j_f0.yin_f0(wav, SR))
    calls = t_native.native_calls["yin_f0"]
    fast = t_f0.yin_f0_fast(wav, SR)
    assert t_native.native_calls["yin_f0"] == calls + 1
    np.testing.assert_array_equal(fast, j_native.yin_f0_native(wav, SR))
    agree = (ref > 0) == (fast > 0)
    assert agree.mean() > 0.99, agree.mean()
    both = (ref > 0) & (fast > 0)
    assert np.abs(ref[both] - fast[both]).max() < 0.1
    for got, want in zip(t_f0.f0_targets(wav, SR, hop=256),
                         j_f0.f0_targets(wav, SR, hop=256)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_native_mas_matches_oracles():
    """The host C++ MAS against the JAX package's numpy oracle and the
    port's plain version on ragged masks."""
    rng = np.random.RandomState(7)
    neg = rng.randn(6, 33, 15).astype(np.float32)
    mask = np.ones_like(neg)
    for i in range(6):
        ty = rng.randint(15, 34)
        tx = rng.randint(2, min(15, ty) + 1)
        mask[i, ty:, :] = 0
        mask[i, :, tx:] = 0
    got = t_native.maximum_path_native(neg.copy(), mask)
    np.testing.assert_array_equal(got, maximum_path_numpy(neg.copy(), mask))
    np.testing.assert_array_equal(got, maximum_path_torch(
        torch.from_numpy(neg), torch.from_numpy(mask)).numpy())


class _RecordingWriter:
    """Stands in for torch.utils.tensorboard.SummaryWriter."""
    calls: list = []

    def __init__(self, log_dir):
        self.calls.append(("init", os.path.basename(log_dir)))

    def add_scalar(self, k, v, step):
        self.calls.append(("scalar", k, v, step))

    def add_image(self, k, img, step, dataformats):
        self.calls.append(("image", k, img.shape[-1], step, dataformats))

    def close(self):
        self.calls.append(("close",))


@pytest.mark.parametrize("tensorboard", [True, False])
def test_metrics_writer_images(tensorboard, tmp_path, monkeypatch):
    """Scalars to JSONL (the JAX writer's rows, time aside) and TensorBoard
    when it imports; arrays and tensors of 2+ dimensions to PNGs under
    images/, or .npy without matplotlib."""
    from music_generation_tpu.train import metrics as j_metrics
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = _RecordingWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        fake if tensorboard else None)
    _RecordingWriter.calls = []
    metrics = {"loss_mel": torch.tensor(1.5), "lr": 2e-4,
               "img_mel_predict": torch.rand(12, 5),
               "img_alignment": np.eye(12, 4, dtype=np.float32)}
    rows = {}
    for tag, mod in (("port", t_metrics), ("jax", j_metrics)):
        w = mod.MetricsWriter(str(tmp_path / tag))
        w.write(3, metrics if tag == "port" else
                {k: np.asarray(v) for k, v in metrics.items()})
        w.close()
        with open(w.path) as fh:
            rows[tag] = json.loads(fh.readline())
        rows[tag].pop("time")
    assert rows["port"] == rows["jax"] == {"step": 3, "loss_mel": 1.5,
                                           "lr": 2e-4}
    images = sorted(os.listdir(tmp_path / "port" / "images"))
    assert images == ["img_alignment_3.png", "img_mel_predict_3.png"]
    calls = _RecordingWriter.calls
    if tensorboard:
        assert ("scalar", "loss_mel", 1.5, 3) in calls
        assert ("image", "img_alignment", 3, 3, "HWC") in calls
        assert calls.count(("close",)) == 2
    else:
        assert calls == []
    monkeypatch.setattr(t_metrics, "plot_spectrogram_to_numpy",
                        lambda a: None)
    w = t_metrics.MetricsWriter(str(tmp_path / "nompl"))
    w.write(0, {"img_alignment": metrics["img_alignment"]})
    w.close()
    np.testing.assert_array_equal(
        np.load(tmp_path / "nompl" / "images" / "img_alignment_0.npy"),
        metrics["img_alignment"])


def test_train_cli_on_corpus(corpora, tmp_path, monkeypatch, capsys):
    """python -m music_generation_tpu_torch.train --tiny --device cpu
    --durations mas --prefetch 0 --log-images on the port's toy corpus,
    through --data-dir and through --packed: a checkpoint, the JSONL and
    the images; steps_per_epoch as the JAX CLI derives it; the first
    step's losses equal across the two readers (same seed, same batch)."""
    from music_generation_tpu_torch.ops import maximum_path
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _, npy, packed = corpora["port"]
    batch_size = 2
    rows = {}
    for flag, src in (("--data-dir", npy), ("--packed", packed)):
        ck = str(tmp_path / flag.strip("-"))
        plain = maximum_path.plain_calls
        train_main(["--tiny", "--device", "cpu", "--durations", "mas",
                    "--prefetch", "0", "--log-images", "--steps", "1",
                    "--batch-size", str(batch_size), "--warmup-steps", "0",
                    "--log-every", "1", "--ckpt-dir", ck, flag, src])
        assert maximum_path.plain_calls == plain + 2
        out = capsys.readouterr().out
        # JAX train/__main__.py: max(1, len(dataset) // batch_size)
        assert f"steps_per_epoch {max(1, N_UTTS // batch_size)}" in out
        assert sorted(os.listdir(ck)) == ["best.json", "logs", "step_1.pt"]
        assert sorted(os.listdir(os.path.join(ck, "logs", "images"))) == [
            f"img_{k}_0.png" for k in ("alignment", "mel_predict",
                                        "spec_predict", "spec_target")]
        with open(os.path.join(ck, "logs", "train_metrics.jsonl")) as fh:
            rows[flag] = json.loads(fh.readline())
        shutil.rmtree(ck)  # the full discriminator's step file, 0.55 GB
    for row in rows.values():
        row.pop("time")
    assert rows["--data-dir"] == rows["--packed"]
    assert all(np.isfinite(v) for v in rows["--packed"].values())
    assert not any(k.startswith("img_") for k in rows["--packed"])
