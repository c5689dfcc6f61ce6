#!/usr/bin/env python3
"""Export train.seq melody checkpoints into a servable pipeline directory.

The port's sequence trainer (``python -m music_generation_tpu_torch.train.seq``)
saves ``{ckpt_dir}/{family}/step_<n>.pt`` holding ``{"params",
"opt_state", "step"}``; the port's server (``serve.app --checkpoint-dir``,
compat.checkpoints.load_pipeline) reads the melody transformer's note and
duration models from ``melody_notes.pt`` and ``melody_duration.pt``, plain
state_dicts. This tool strips a ``melody_note`` and a ``duration_mse``
checkpoint to their params and writes them there, next to any
``svs_<id>.pt`` from tools/torch_export_trained_svs.py. Twin of
tools/export_trained_melody.py; imports no JAX.

Usage:
  python tools/torch_export_trained_melody.py \
      --notes ckpts/melody_note/step_800.pt \
      --duration ckpts/duration_mse/step_800.pt --out served
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _params(path: str) -> dict:
    import torch
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or "params" not in state:
        what = list(state)[:4] if isinstance(state, dict) else type(state)
        raise ValueError(f"{path}: not a train.seq checkpoint ({what})")
    return {k: v.detach().cpu() for k, v in state["params"].items()}


def export_melody(notes: str, duration: str, out: str) -> list:
    """Write <out>/melody_notes.pt and <out>/melody_duration.pt from a
    melody_note and a duration_mse step_<n>.pt. Returns the paths."""
    import torch

    from music_generation_tpu_torch.compat.checkpoints import _MELODY_FILES

    os.makedirs(out, exist_ok=True)
    paths = []
    for name, src in zip(_MELODY_FILES, (notes, duration)):
        path = os.path.join(out, name)
        torch.save(_params(src), path)
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--notes", required=True,
                   help="train.seq melody_note step_<n>.pt")
    p.add_argument("--duration", required=True,
                   help="train.seq duration_mse step_<n>.pt")
    p.add_argument("--out", required=True,
                   help="pipeline checkpoint dir (melody_notes.pt + "
                        "melody_duration.pt written next to svs_*)")
    args = p.parse_args(argv)
    try:
        paths = export_melody(args.notes, args.duration, args.out)
    except ValueError as e:
        p.error(str(e))
    for path in paths:
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
