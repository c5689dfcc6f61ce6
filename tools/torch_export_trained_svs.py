#!/usr/bin/env python3
"""Export a port trainer checkpoint into a servable pipeline directory.

The port's trainer (``python -m music_generation_tpu_torch.train``) writes
``step_<n>.pt`` files holding the generator, the discriminator and both
optimizers; the port's server (``serve.app --checkpoint-dir``) loads
``svs_<id>.pt`` files (compat.checkpoints.load_pipeline). This tool strips
the trainer checkpoint to the generator (key ``"gen"``), checks it against
the SVSConfig that --tiny, --decoder, --nsf and --f0-residual select (the
trainer's flags), and writes it under every requested singer id. Twin of
tools/export_trained_svs.py; imports no JAX.

Usage:
  python tools/torch_export_trained_svs.py --ckpt ckpts/step_1000.pt \
      --out served [--decoder hifigan|istft|mb_istft] [--nsf] \
      [--f0-residual] [--tiny] [--speakers 0 1 2]

Then serve it with the same flags:
  python -m music_generation_tpu_torch.serve.app --checkpoint-dir served \
      [--decoder ...] [--nsf] [--f0-residual]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def export_svs(ckpt: str, out: str, speakers=(0,), tiny: bool = False,
               decoder: str = "hifigan", nsf: bool = False,
               f0_residual: bool = False) -> list:
    """Write <out>/svs_<id>.pt for each of ``speakers``: the generator of
    the trainer checkpoint ``ckpt``, which must load strictly into the
    port's VISinger(build_svs_config(tiny, decoder, nsf, f0_residual)).
    Returns the paths."""
    import torch

    from music_generation_tpu_torch.compat import save_params
    from music_generation_tpu_torch.models.svs import VISinger
    from music_generation_tpu_torch.train import build_svs_config

    model = VISinger(build_svs_config(tiny=tiny, decoder=decoder, nsf=nsf,
                                      f0_residual=f0_residual))
    gen = torch.load(ckpt, map_location="cpu", weights_only=True)["gen"]
    model.load_state_dict(gen, strict=True)
    paths = []
    for sid in speakers:
        path = os.path.join(out, f"svs_{sid}.pt")
        save_params(path, model)
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="a trainer step_<n>.pt file")
    p.add_argument("--out", required=True,
                   help="pipeline checkpoint dir to write (svs_<id>.pt)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--decoder", default="hifigan",
                   choices=("hifigan", "istft", "mb_istft"),
                   help="the trainer's --decoder")
    p.add_argument("--nsf", action="store_true", help="the trainer's --nsf")
    p.add_argument("--f0-residual", action="store_true",
                   help="the trainer's --f0-residual")
    p.add_argument("--speakers", type=int, nargs="+", default=[0])
    args = p.parse_args(argv)
    try:
        paths = export_svs(args.ckpt, args.out, args.speakers,
                           tiny=args.tiny, decoder=args.decoder,
                           nsf=args.nsf, f0_residual=args.f0_residual)
    except ValueError as e:  # --nsf with another decoder
        p.error(str(e))
    except RuntimeError as e:  # keys or shapes of another configuration
        flags = "".join(f" --{f}" for f, on in (
            ("nsf", args.nsf), ("f0-residual", args.f0_residual),
            ("tiny", args.tiny)) if on)
        p.error(f"{args.ckpt} does not match --decoder {args.decoder}"
                f"{flags}: {str(e)[:300]}")
    for path in paths:
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
