"""Training metrics sink: JSONL file + optional TensorBoard + images.

Twin of music_generation_tpu/train/metrics.py. Replaces the reference's
TensorBoard `summarize` helper (VISinger/utils/utils.py:74-83). JSONL is
the primary sink (greppable, dependency-free); TensorBoard is written when
``torch.utils.tensorboard`` imports and skipped when it does not. Values of
2 or more dimensions (numpy arrays or tensors, on any device: the trainer's
``img_*`` metrics under ``--log-images``) are rendered as heatmaps under
``<log_dir>/images``: a PNG when matplotlib imports, else the image as
``.npy``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = open(self._path, "a", encoding="utf-8")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def write(self, step: int, metrics: dict) -> None:
        """``metrics``: scalars (numbers or 0-dim tensors) and images
        (arrays or tensors of 2 or more dimensions, copied to the host
        here)."""
        scalars, arrays = {}, {}
        for k, v in metrics.items():
            (arrays if getattr(v, "ndim", 0) >= 2 else scalars)[k] = v
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, int(step))
        for k, v in arrays.items():
            self.write_image(step, k, v)

    def write_image(self, step: int, name: str, array) -> None:
        """Render a [T, C] array as a heatmap PNG under <log_dir>/images and
        to TensorBoard (parity: the reference's spectrogram/alignment image
        summaries, VISinger/utils/utils.py:93-146 + plot.py:8-45); without
        matplotlib the array itself is saved as .npy."""
        if hasattr(array, "detach"):
            array = array.detach().float().cpu().numpy()
        array = np.asarray(array, dtype=np.float32)
        img_dir = os.path.join(os.path.dirname(self._path), "images")
        os.makedirs(img_dir, exist_ok=True)
        img = plot_spectrogram_to_numpy(array)
        if img is None:
            np.save(os.path.join(img_dir, f"{name}_{int(step)}.npy"), array)
            return
        from matplotlib import image as mpimg
        mpimg.imsave(os.path.join(img_dir, f"{name}_{int(step)}.png"), img)
        if self._tb is not None:
            self._tb.add_image(name, img, int(step), dataformats="HWC")

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()

    @property
    def path(self) -> str:
        return self._path


def plot_spectrogram_to_numpy(spectrogram):
    """[T, C] -> HWC uint8 heatmap (channels up, frames right), the
    reference's plot_spectrogram_to_numpy re-expressed
    (VISinger/utils/utils.py:93-117). Returns None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pylab as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spectrogram.T, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return data
