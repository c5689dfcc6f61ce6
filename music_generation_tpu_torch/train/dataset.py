"""Dataset pipeline: cpop-style preprocessing + bucketed npy batch loader.

Twin of music_generation_tpu/train/dataset.py: the same npy files, the same
packed file and, for one seed, the same batches (``spec`` up to float32
rounding of the FFT). Replaces the reference's offline preprocessor
(cpop_text_preprocessor.py main(): per-utterance .npy files) and its mmap
IndexedDataset (VISinger/utils/indexed_datasets.py) with a simple
npy-per-field layout and a host-side loader that emits fixed-shape numpy
batches (train.data.BATCH_KEYS) for the train step; the trainer's
prefetcher assembles them, spectrogram included, on its producer thread
and copies them to the device.

Transcription line format (parity with ../datasets/transcriptions.txt):
  name|text|phones|notes|note_durations|phone_durations
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..audio.stft import spectrogram
from ..frontend import note_id
from ..frontend.vocab import phone_vocab, shengdiao_vocab
from ..models.svs import SVSConfig

FIELDS = ("phone-ids", "note-ids", "note-durations", "phone-duration",
          "shengdiao-ids")


def quantize_phone_durations(durations: list[float],
                             frame_len: float = 0.0125) -> list[int]:
    """Seconds -> frame counts with bias carry (parity:
    cpop_text_preprocessor.format_phone_duration :108-145)."""
    K = 10_000_000
    frame = int(frame_len * K)
    total = sum(durations)
    n_target = int(total * K) // frame + (1 if int(total * K) % frame else 0)
    out, bias = [], 0
    for d in durations:
        di = int(K * d) + bias
        if di < frame:
            n, bias = 1, di - frame
        else:
            n, left = divmod(di, frame)
            if left / frame > 0.5:
                n += 1
                bias = left - frame
            else:
                bias = left
        out.append(n)
    if bias > 0:
        out[-1] += 1
    if sum(out) != n_target:
        out[-1] -= 1
    return out


def preprocess_transcriptions(path: str, out_dir: str,
                              wav_dir: Optional[str] = None,
                              sample_rate: int = 22050,
                              hop: int = 256) -> int:
    """Offline id-ification of a transcription file -> npy files.

    When ``wav_dir`` holds a ``<name>.wav`` per utterance, also ingests the
    audio: writes ``-wav.npy`` (float32 mono at ``sample_rate``) plus the
    per-frame F0 training targets ``-log-f0.npy`` / ``-f0-score.npy``
    extracted with the in-tree YIN tracker (audio/f0.py; parity target:
    the f0_score/log_f0 inputs of VISinger/models.py:557-620); through the
    native host code when it built (runtime/native_loader.py)."""
    os.makedirs(out_dir, exist_ok=True)
    pv, sv = phone_vocab(), shengdiao_vocab()
    n = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, _text, phones, notes, note_durs, phone_durs = \
                line.split("|")[:6]
            base = os.path.join(out_dir, name)
            if wav_dir is not None:
                wav_path = os.path.join(wav_dir, f"{name}.wav")
                if os.path.exists(wav_path):
                    _ingest_wav(wav_path, base, sample_rate, hop)
            tone_phones = phones.split(" ")
            plain = " ".join(p.rstrip("12345") for p in tone_phones)
            np.save(f"{base}-phone-ids.npy",
                    np.asarray(pv.encode(plain), np.int32))
            np.save(f"{base}-shengdiao-ids.npy",
                    np.asarray(sv.encode(phones), np.int32))
            np.save(f"{base}-note-ids.npy",
                    np.asarray([note_id(x) for x in notes.split(" ")],
                               np.int32))
            np.save(f"{base}-note-durations.npy",
                    np.asarray([float(x) for x in note_durs.split(" ")],
                               np.float32))
            np.save(f"{base}-phone-duration.npy",
                    np.asarray(quantize_phone_durations(
                        [float(x) for x in phone_durs.split(" ")]), np.int32))
            n += 1
    return n


def _ingest_wav(wav_path: str, base: str, sample_rate: int, hop: int) -> None:
    from ..audio.f0 import f0_targets
    from ..audio.wav import read_wav, resample
    sr, wav = read_wav(wav_path)
    if np.issubdtype(wav.dtype, np.integer):
        wav = wav.astype(np.float32) / float(np.iinfo(wav.dtype).max)
    wav = np.asarray(wav, np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    if sr != sample_rate:
        wav = resample(wav, sr, sample_rate).astype(np.float32)
    np.save(f"{base}-wav.npy", wav)
    log_f0, f0_score = f0_targets(wav, sample_rate=sample_rate, hop=hop)
    np.save(f"{base}-log-f0.npy", log_f0)
    np.save(f"{base}-f0-score.npy", f0_score)


@dataclass
class NpyDataset:
    """Bucketing batch loader over preprocessed npy files + wavs. Batches
    are numpy; ``spec`` is computed on the CPU with audio.stft.spectrogram,
    as train.data.synthetic_batch computes it."""
    data_dir: str
    cfg: SVSConfig
    t_phones: int = 64
    t_frames: int = 480
    seed: int = 0

    def __post_init__(self):
        ids = sorted(p[: -len("-phone-ids.npy")] for p in
                     glob.glob(os.path.join(self.data_dir, "*-phone-ids.npy")))
        self.names = [os.path.basename(p) for p in ids]
        self._rng = np.random.RandomState(self.seed)

    def __len__(self):
        return len(self.names)

    def _load(self, name):
        base = os.path.join(self.data_dir, name)
        item = {f: np.load(f"{base}-{f}.npy") for f in FIELDS
                if os.path.exists(f"{base}-{f}.npy")}
        for extra in ("wav", "log-f0", "f0-score"):
            p = f"{base}-{extra}.npy"
            if os.path.exists(p):
                item[extra] = np.load(p)
        return item

    def _load_many(self, picks):
        return [self._load(self.names[p]) for p in picks]

    def batch(self, batch_size: int) -> dict:
        """Fixed-shape batch dict matching train.data.BATCH_KEYS."""
        cfg = self.cfg
        picks = self._rng.choice(len(self.names), batch_size)
        out = {
            "phones": np.zeros((batch_size, self.t_phones), np.int32),
            "x_lengths": np.zeros((batch_size,), np.int32),
            "note_ids": np.zeros((batch_size, self.t_phones), np.int32),
            "note_durations": np.zeros((batch_size, self.t_phones), np.float32),
            "phone_durations": np.zeros((batch_size, self.t_phones), np.int32),
            "shengdiao": np.zeros((batch_size, self.t_phones), np.int32),
            "y_lengths": np.zeros((batch_size,), np.int32),
            "audio": np.zeros((batch_size, self.t_frames * cfg.hop_length, 1),
                              np.float32),
            "f0_score": np.ones((batch_size, self.t_frames), np.int32),
            "log_f0": np.zeros((batch_size, self.t_frames), np.float32),
        }
        items = self._load_many(picks)
        for i, item in enumerate(items):
            t = min(len(item["phone-ids"]), self.t_phones)
            out["phones"][i, :t] = item["phone-ids"][:t]
            out["x_lengths"][i] = t
            out["note_ids"][i, :t] = item["note-ids"][:t]
            out["note_durations"][i, :t] = item["note-durations"][:t]
            pd = item["phone-duration"][:t]
            out["phone_durations"][i, :t] = pd
            out["y_lengths"][i] = min(int(pd.sum()), self.t_frames)
            if "shengdiao-ids" in item:
                out["shengdiao"][i, :t] = item["shengdiao-ids"][:t]
            if "wav" in item:
                w = item["wav"][: self.t_frames * cfg.hop_length]
                out["audio"][i, : len(w), 0] = w
            # ground-truth F0 targets when ingested (audio/f0.py);
            # synthetic-batch fallbacks (ones/zeros) otherwise
            if "log-f0" in item:
                lf = item["log-f0"][: self.t_frames]
                out["log_f0"][i, : len(lf)] = lf
            if "f0-score" in item:
                fs = item["f0-score"][: self.t_frames]
                out["f0_score"][i, : len(fs)] = fs
        n_fft = 2 * (cfg.spec_channels - 1)
        spec = spectrogram(torch.from_numpy(out["audio"][..., 0]),
                           n_fft=n_fft, hop=cfg.hop_length,
                           win_length=n_fft).numpy()
        out["spec"] = spec[:, : self.t_frames].astype(np.float32)
        return out


def pack_dataset(npy_dir: str, out_path: str) -> int:
    """Pack a preprocessed-npy directory into one indexed binary dataset
    (``out_path.data`` + ``out_path.idx``; runtime/indexed_dataset.py —
    the native rebuild of VISinger/utils/indexed_datasets.py)."""
    from ..runtime import IndexedDatasetBuilder
    src = NpyDataset.__new__(NpyDataset)
    src.data_dir = npy_dir
    ids = sorted(p[: -len("-phone-ids.npy")] for p in
                 glob.glob(os.path.join(npy_dir, "*-phone-ids.npy")))
    names = [os.path.basename(p) for p in ids]
    builder = IndexedDatasetBuilder(out_path)
    for name in names:
        item = dict(src._load(name))
        item["name"] = np.frombuffer(name.encode("utf-8"), np.uint8)
        builder.add_item(item)
    builder.finalize()
    return len(names)


@dataclass
class PackedDataset(NpyDataset):
    """NpyDataset over one packed indexed-dataset file instead of a
    directory of per-field npy files; ``data_dir`` is the path prefix passed
    to pack_dataset. Batches are bit-identical to NpyDataset's for the same
    seed; reads are native mmap gathers (no per-field file opens)."""

    def __post_init__(self):
        from ..runtime import IndexedDataset
        self._ds = IndexedDataset(self.data_dir)
        self.names = [
            bytes(self._ds[i]["name"].tobytes()).decode("utf-8")
            for i in range(len(self._ds))]
        self._rng = np.random.RandomState(self.seed)

    def _load(self, name):
        item = self._ds[self.names.index(name)]
        return {k: v for k, v in item.items() if k != "name"}

    def _load_many(self, picks):
        items = self._ds.read_batch([int(p) for p in picks])
        return [{k: v for k, v in it.items() if k != "name"}
                for it in items]

    def close(self):
        self._ds.close()


def main(argv=None):
    """Offline preprocessing CLI:
    python -m music_generation_tpu_torch.train.dataset transcriptions.txt \
        out_dir \
        [--wav-dir wavs] [--sample-rate 22050] [--hop 256] [--pack prefix]"""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m music_generation_tpu_torch.train.dataset")
    p.add_argument("transcriptions")
    p.add_argument("out_dir")
    p.add_argument("--wav-dir", default=None)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--hop", type=int, default=256)
    p.add_argument("--pack", default=None, metavar="PREFIX",
                   help="also pack the npy dir into PREFIX.data/.idx")
    args = p.parse_args(argv)
    n = preprocess_transcriptions(args.transcriptions, args.out_dir,
                                  wav_dir=args.wav_dir,
                                  sample_rate=args.sample_rate, hop=args.hop)
    print(f"preprocessed {n} utterances -> {args.out_dir}")
    if args.pack:
        m = pack_dataset(args.out_dir, args.pack)
        print(f"packed {m} utterances -> {args.pack}.data/.idx")


if __name__ == "__main__":
    main()
