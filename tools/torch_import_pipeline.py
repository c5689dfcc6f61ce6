#!/usr/bin/env python3
"""Convert trained weights into a pipeline directory the port's server
serves (``serve.app --checkpoint-dir``).

Two inputs:
  --jax-dir DIR   a JAX orbax pipeline directory (svs_<id>, melody_notes,
                  melody_duration), as the JAX package's save_pipeline,
                  tools/import_reference_checkpoints.py,
                  tools/export_trained_svs.py or
                  tools/export_trained_melody.py write it. Each tree goes
                  through the port's compat.from_jax mappers (VISinger; the
                  melody notes and the MSE or SDP durations). This input
                  imports jax and orbax.
  --pth FILE      the reference's VISinger .pth (repeatable: singer ids in
                  order), raw or in the reference trainer's {"model": ...}
                  wrapper, through compat.torch_import. No JAX.
Both write svs_<id>.pt (and, from a JAX directory of the transformer melody
family, melody_notes.pt and melody_duration.pt) under --out. --tiny,
--decoder, --nsf, --f0-residual and --variant select the configuration the
server will build (serve.app's flags of the same names); a tree of another
configuration is refused. --no-autoencoder converts the plain (non-AE)
VISinger: the reference's models.py file, or a JAX tree of
SVSConfig(autoencoder=False); the server builds that variant from the
files it loads (compat.checkpoints.load_pipeline). The reference's .pth
has no NSF excitation convs, so --pth with --nsf is refused. The JAX
package does not save the seq2seq melody (melody_v2), so neither does
this tool.

Usage:
  python tools/torch_import_pipeline.py --jax-dir jax_pipeline --out served \
      [--variant svs_v6_multispeaker] [--decoder hifigan] [--nsf] \
      [--f0-residual] [--tiny]
  python tools/torch_import_pipeline.py --pth G_AE.pth [--pth G_AE_F09.pth] \
      --out served [--tiny]
  python tools/torch_import_pipeline.py --pth G.pth --no-autoencoder \
      --out served [--tiny]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def svs_config(tiny: bool, decoder: str, nsf: bool = False,
               f0_residual: bool = False, autoencoder: bool = True):
    """The SVSConfig serve.app builds for --tiny, --decoder, --nsf and
    --f0-residual (with ``autoencoder`` False: the plain variant)."""
    from music_generation_tpu_torch.models.svs import SVSConfig
    from music_generation_tpu_torch.pipeline.synthesis import tiny_configs
    return dataclasses.replace(tiny_configs(0)[1] if tiny else SVSConfig(),
                               decoder_type=decoder, nsf=nsf,
                               f0_residual=f0_residual,
                               autoencoder=autoencoder)


def _restore_orbax(path: str) -> dict:
    import numpy as np
    import orbax.checkpoint as ocp
    from jax.tree_util import tree_map
    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    return tree_map(lambda a: np.asarray(a, np.float32), raw)


def _save(state_dict: dict, path: str) -> None:
    import torch
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state_dict, path)
    print(f"wrote {path}")


def import_jax_dir(jax_dir: str, out: str, variant: str = "svs_v6_multispeaker",
                   decoder: str = "hifigan", tiny: bool = False,
                   nsf: bool = False, f0_residual: bool = False,
                   autoencoder: bool = True) -> list:
    """Convert a JAX pipeline directory; returns the files written."""
    from music_generation_tpu_torch.compat.from_jax import (
        melody_rename, sdp_state_dict_from_flax, state_dict_from_flax,
        visinger_state_dict_from_flax)
    from music_generation_tpu_torch.pipeline.synthesis import (
        build_melody_generator)
    from music_generation_tpu_torch.serve.variants import VARIANTS

    cfg = svs_config(tiny, decoder, nsf, f0_residual, autoencoder)
    written = []
    for name in sorted(os.listdir(jax_dir)):
        if re.fullmatch(r"svs_\d+", name):
            # a served tree (initialised through infer) has no
            # spec_encoder: those parameters stay at init when loaded
            sd = visinger_state_dict_from_flax(
                _restore_orbax(os.path.join(jax_dir, name)), cfg,
                strict=False)
            written.append(os.path.join(out, f"{name}.pt"))
            _save(sd, written[-1])
    family = VARIANTS[variant].melody
    if family not in ("mse", "sdp"):
        print(f"variant {variant}: the {family} melody is not saved in a "
              "pipeline directory; only the SVS models are converted")
        return written
    gen = build_melody_generator(tiny, device="cpu", duration_variant=family)
    convert = {
        "melody_notes": lambda tree: state_dict_from_flax(
            tree, gen.note_model, melody_rename),
        "melody_duration": (
            (lambda tree: state_dict_from_flax(tree, gen.duration_model,
                                               melody_rename))
            if family == "mse" else
            (lambda tree: sdp_state_dict_from_flax(tree, gen.sdp_cfg)))}
    for name, fn in convert.items():
        path = os.path.join(jax_dir, name)
        if os.path.isdir(path):
            written.append(os.path.join(out, f"{name}.pt"))
            _save(fn(_restore_orbax(path)), written[-1])
    return written


def import_pth(files: list, out: str, tiny: bool = False,
               nsf: bool = False, f0_residual: bool = False,
               autoencoder: bool = True) -> list:
    """Convert reference .pth files to svs_0.pt, svs_1.pt, ... in order;
    returns the files written (an ``nsf`` config is refused, and a file of
    the other AE variant than ``autoencoder``)."""
    import torch

    from music_generation_tpu_torch.compat import (
        visinger_state_dict_from_torch)
    cfg = svs_config(tiny, "hifigan", nsf, f0_residual, autoencoder)
    written = []
    for i, path in enumerate(files):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        written.append(os.path.join(out, f"svs_{i}.pt"))
        _save(visinger_state_dict_from_torch(blob, cfg), written[-1])
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--jax-dir", help="JAX orbax pipeline directory")
    src.add_argument("--pth", action="append",
                     help="reference VISinger .pth (repeatable)")
    p.add_argument("--out", required=True,
                   help="port pipeline directory to write")
    p.add_argument("--variant", default="svs_v6_multispeaker",
                   choices=["svs_v6_multispeaker", "svs_v5",
                            "svs_v5_multispeaker", "melody_v2"],
                   help="serve.app --variant: picks the melody family")
    p.add_argument("--decoder", default="hifigan",
                   choices=["hifigan", "istft", "mb_istft"])
    p.add_argument("--nsf", action="store_true",
                   help="the SVS trees were trained with train --nsf")
    p.add_argument("--f0-residual", action="store_true",
                   help="the SVS trees were trained with train "
                        "--f0-residual")
    p.add_argument("--no-autoencoder", action="store_true",
                   help="the plain (non-AE) VISinger: the reference's "
                        "models.py file, without spec_decoder")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    if args.pth and args.decoder != "hifigan":
        p.error("reference .pth files carry the HiFi-GAN decoder")
    if args.nsf and args.decoder != "hifigan":
        p.error("--nsf requires --decoder hifigan")
    try:
        if args.jax_dir:
            import_jax_dir(args.jax_dir, args.out, args.variant,
                           args.decoder, args.tiny, args.nsf,
                           args.f0_residual, not args.no_autoencoder)
        else:
            import_pth(args.pth, args.out, args.tiny, args.nsf,
                       args.f0_residual, not args.no_autoencoder)
    except (ValueError, NotImplementedError) as e:
        p.error(str(e)[:500])


if __name__ == "__main__":
    main()
