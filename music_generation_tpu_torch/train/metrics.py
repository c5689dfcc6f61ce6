"""Training metrics sink: one JSON line per logged step.

Twin of the JSONL part of music_generation_tpu/train/metrics.py (scalars
only; TensorBoard and image summaries are not ported yet).
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = open(self._path, "a", encoding="utf-8")

    def write(self, step: int, metrics: dict) -> None:
        """``metrics``: scalars (numbers or 0-dim tensors)."""
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    @property
    def path(self) -> str:
        return self._path
