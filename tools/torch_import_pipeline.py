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
  --jax-step DIR  a JAX GAN trainer's orbax step_<n> directory (gen and
                  disc, each with params, opt_state and step) -> the port
                  trainer's <out>/step_<n>.pt (train.trainer.
                  restore_checkpoint reads it; --tiny, --decoder, --nsf and
                  --f0-residual are the trainer's flags). Imports jax and
                  orbax.
  --jax-seq-step DIR --family F
                  a JAX train.seq step_<n> directory (params, opt_state,
                  step) -> <out>/F/step_<n>.pt, the port's
                  save_seq_checkpoint layout (train.seq --resume reads it;
                  --tiny as train.seq's). Imports jax and orbax.
The optimizer state carries across: optax's Adam mu and nu become torch's
exp_avg and exp_avg_sq, its count the Adam step (and the GAN Optimizer's
count), MultiSteps' mini_step and acc_grads the Optimizer's mini_step and
acc, each moment through its parameter's layout transform. A state whose
layout does not map is left out, as the JAX restore leaves it: the file
holds the params and the step and a fresh optimizer, and the tool says so.
The pipeline inputs write svs_<id>.pt (and, from a JAX directory of the
transformer melody family, melody_notes.pt and melody_duration.pt) under
--out. --tiny,
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
  python tools/torch_import_pipeline.py --jax-step ckpts/step_400 \
      --out port_ckpts [--tiny] [--decoder ...] [--nsf] [--f0-residual]
  python tools/torch_import_pipeline.py \
      --jax-seq-step seq/melody_note/step_14 --family melody_note \
      --out port_seq [--tiny]
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


def _find(tree, keys: tuple):
    """The first dict node of ``tree`` (depth first) that holds ``keys``."""
    if isinstance(tree, dict):
        if all(k in tree for k in keys):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def _adam_state(opt_tree, to_port, params: list, names: list):
    """(count, {index: torch Adam state}, mini_step, acc or None) of an
    optax state tree: ScaleByAdamState's count, mu and nu, and
    MultiStepsState's mini_step and acc_grads, the moments through
    ``to_port`` (a flax tree -> port state_dict mapper) in the order of
    ``names``. Raises ValueError when the layout does not map."""
    import torch
    adam = _find(opt_tree, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state")
    mu, nu = to_port(adam["mu"]), to_port(adam["nu"])
    count = int(adam["count"])
    state = {}
    for i, (name, p) in enumerate(zip(names, params)):
        if name not in mu or name not in nu:
            raise ValueError(f"no moments for {name}")
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"moments of {name}: {tuple(mu[name].shape)} "
                             f"for {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(count)),
                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    multi = _find(opt_tree, ("mini_step", "acc_grads"))
    acc = None
    if multi is not None:
        grads = to_port(multi["acc_grads"])
        acc = [grads[n] for n in names]
    return count, state, (int(multi["mini_step"]) if multi else 0), acc


def _step_of(path: str, raw_step) -> int:
    m = re.fullmatch(r"step_(\d+)", os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else int(raw_step)


def convert_gan_step(step_dir: str, out: str, tiny: bool = False,
                     decoder: str = "hifigan", nsf: bool = False,
                     f0_residual: bool = False) -> str:
    """A JAX GAN trainer step directory -> <out>/step_<n>.pt in the port
    trainer's layout; returns the file."""
    import torch

    from music_generation_tpu_torch.compat.from_jax import (
        mpd_state_dict_from_flax, visinger_state_dict_from_flax)
    from music_generation_tpu_torch.models.svs import (
        MultiPeriodDiscriminator, VISinger)
    from music_generation_tpu_torch.train import TrainConfig, build_svs_config
    from music_generation_tpu_torch.train.trainer import Optimizer

    cfg = build_svs_config(tiny=tiny, decoder=decoder, nsf=nsf,
                           f0_residual=f0_residual)
    raw = _restore_orbax(step_dir)
    blob = {}
    for key, build, mapper in (
            ("gen", lambda: VISinger(cfg),
             lambda tree: visinger_state_dict_from_flax(tree, cfg)),
            ("disc", MultiPeriodDiscriminator, mpd_state_dict_from_flax)):
        with torch.device("meta"):  # the weights come from the tree
            model = build()
        model.load_state_dict(mapper(raw[key]["params"]), assign=True)
        names = [n for n, _ in model.named_parameters()]
        opt = Optimizer(model.parameters(), TrainConfig())
        fresh = opt.state_dict()
        try:
            count, state, mini_step, acc = _adam_state(
                raw[key]["opt_state"], mapper, list(model.parameters()),
                names)
            opt_sd = {"count": count, "mini_step": mini_step,
                      "adam": {"state": state,
                               "param_groups": fresh["adam"]["param_groups"]},
                      "acc": acc}
        except (ValueError, KeyError) as e:
            print(f"{key}: the optimizer state does not map ({e}); "
                  f"params and step only, with a fresh optimizer")
            opt_sd = fresh
        blob.update({key: model.state_dict(), f"{key}_opt": opt_sd,
                     f"{key}_step": int(raw[key]["step"])})
    path = os.path.join(out, f"step_{_step_of(step_dir, raw['gen']['step'])}"
                             f".pt")
    _save(blob, path)
    return path


def _seq_mapper(family: str, model):
    """The flax tree -> state_dict mapper of a train.seq family's model
    (an nn.ModuleDict for the joint families)."""
    from music_generation_tpu_torch.compat import from_jax as fj
    if family == "seq2seq":
        return lambda tree: {
            f"{k}.{n}": v for k in model
            for n, v in fj.seq2seq_state_dict_from_flax(
                tree[k], model[k].cfg).items()}
    if family == "telemelody":
        return lambda tree: {
            f"{k}.{n}": v for k in model
            for n, v in fj.state_dict_from_flax(
                tree[k], model[k], fj.melody_rename).items()}
    rename = {"t5": fj._suffixed_rename, "gpt2": fj._suffixed_rename,
              "duration_sdp": lambda n: n}.get(family, fj.melody_rename)
    return lambda tree: fj.state_dict_from_flax(tree, model, rename)


def convert_seq_step(step_dir: str, out: str, family: str,
                     tiny: bool = False, lr: float = 3e-4) -> str:
    """A JAX train.seq step directory of ``family`` -> <out>/<family>/
    step_<n>.pt (save_seq_checkpoint's layout); returns the file."""
    import torch

    from music_generation_tpu_torch.train.seq import (build_family,
                                                      save_seq_checkpoint)
    from music_generation_tpu_torch.train.seq_losses import SeqOptimizer

    raw = _restore_orbax(step_dir)
    model, _, _ = build_family(family, tiny, None, device="cpu")
    mapper = _seq_mapper(family, model)
    missing, unknown = model.load_state_dict(mapper(raw["params"]),
                                             strict=False)
    params = dict(model.named_parameters())
    if unknown or any(n in params for n in missing):
        raise ValueError(f"{family}: unknown {unknown}, missing {missing}")
    opt = SeqOptimizer(model.parameters(), lr)
    step = _step_of(step_dir, raw["step"])
    try:
        _, state, _, _ = _adam_state(raw["opt_state"], mapper,
                                     list(params.values()), list(params))
        opt.load_state_dict({"state": state, "param_groups":
                             opt.state_dict()["param_groups"]})
    except (ValueError, KeyError) as e:
        print(f"{family}: the optimizer state does not map ({e}); params "
              f"and step only, with a fresh optimizer")
    path = os.path.join(out, family, f"step_{step}.pt")
    save_seq_checkpoint(path, model, opt, step)
    print(f"wrote {path}")
    return path


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
    src.add_argument("--jax-step", help="JAX GAN trainer step_<n> directory")
    src.add_argument("--jax-seq-step",
                     help="JAX train.seq step_<n> directory (with --family)")
    p.add_argument("--family", default=None,
                   help="train.seq family of --jax-seq-step")
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
    if bool(args.jax_seq_step) != bool(args.family):
        p.error("--jax-seq-step and --family go together")
    try:
        if args.jax_step:
            convert_gan_step(args.jax_step, args.out, args.tiny, args.decoder,
                             args.nsf, args.f0_residual)
        elif args.jax_seq_step:
            convert_seq_step(args.jax_seq_step, args.out, args.family,
                             args.tiny)
        elif args.jax_dir:
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
