"""Carry the JAX package's parameter trees over to the port's modules.

The trees come in as nested dicts of numpy arrays (flax's ``params``
collection, with or without the outer ``{"params": ...}``); this module
imports no JAX. Layouts:
  - conv             [K, I, O] -> [O, I, K]
  - 2-D conv         [H, W, I, O] (HWIO) -> [O, I, H, W]
  - transposed conv  [K, I, O] -> flipped along K, then [I, O, K]
  - dense            [in, out] -> [out, in]
  - weight norm: (kernel, g) kept as is (the port stores the same pair)
Every leaf must be consumed and every parameter of the port module filled,
with matching shapes; anything else raises.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.layers import Conv1d, ConvTranspose1d
from ..models.lyrics.gpt2 import GPT2, GPT2Config
from ..models.lyrics.t5 import T5, T5Config
from ..models.melody.transformer import (MelodyConfig, MelodyTransformer,
                                         MSEDurationModel)
from ..models.svs.hifigan import MultiPeriodDiscriminator
from ..models.svs.visinger import SVSConfig, VISinger

_INDEXED = re.compile(r"^([a-z][a-z0-9]*(?:_[a-z][a-z0-9]*)*)_(\d+)(?:_(\d+))?$")
_RENAME = {"in": "in_layers", "res_skip": "res_skip_layers",
           "Conv1d.0": "conv_1", "Conv1d.1": "conv_2"}
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _segment(seg: str) -> str:
    """'attn_0' -> 'attn.0', 'res_1_2' -> 'res.1.2', 'in_3' ->
    'in_layers.3'; FFN's 'Conv1d_0/1' -> 'conv_1/2'."""
    if seg in ("Conv1d_0", "Conv1d_1"):
        return _RENAME["Conv1d." + seg[-1]]
    m = _INDEXED.match(seg)
    if not m:
        return seg
    name = _RENAME.get(m.group(1), m.group(1))
    return ".".join(g for g in (name, m.group(2), m.group(3)) if g)


def _port_name(path: tuple) -> str:
    segs = [s for s in path if s != "LayerNorm_0"]
    leaf = _LEAF.get(segs[-1], segs[-1])
    return ".".join([_segment(s) for s in segs[:-1]] + [leaf])


def _convert(module: nn.Module, name: str, value: np.ndarray) -> np.ndarray:
    if name.rpartition(".")[2] != "weight":
        return value
    if isinstance(module, ConvTranspose1d):
        return np.transpose(value[::-1], (1, 2, 0))
    if isinstance(module, Conv1d):
        return np.transpose(value, (2, 1, 0))
    if isinstance(module, nn.Conv2d):
        return np.transpose(value, (3, 2, 0, 1))
    if isinstance(module, nn.Linear):
        return value.T
    return value


def state_dict_from_flax(params: dict, model: nn.Module,
                         rename: Callable[[str], str] = lambda n: n) -> dict:
    """state_dict for ``model`` from the matching flax tree (any port
    module whose submodule names follow the JAX package's)."""
    params = params.get("params", params)
    targets = dict(model.named_parameters())
    modules = dict(model.named_modules())
    state, unknown = {}, []
    for path, value in _flatten(params):
        name = rename(_port_name(path))
        if name not in targets:
            unknown.append("/".join(path) + " -> " + name)
            continue
        out = _convert(modules[name.rpartition(".")[0]], name, value)
        if tuple(out.shape) != tuple(targets[name].shape):
            raise ValueError(f"{'/'.join(path)} -> {name}: shape "
                             f"{out.shape} != {tuple(targets[name].shape)}")
        if name in state:
            raise ValueError(f"two leaves map onto {name}")
        state[name] = torch.from_numpy(np.array(out))
    missing = sorted(set(targets) - set(state))
    if unknown or missing:
        raise ValueError(f"unconsumed leaves: {unknown}; "
                         f"unfilled parameters: {missing}")
    return state


def visinger_state_dict_from_flax(params: dict, cfg: SVSConfig) -> dict:
    """state_dict for the port's VISinger(cfg) from the JAX VISinger tree
    (which must hold every submodule, spec_encoder included)."""
    with torch.device("meta"):
        model = VISinger(cfg)
    return state_dict_from_flax(params, model)


def mpd_state_dict_from_flax(params: dict) -> dict:
    """state_dict for the port's MultiPeriodDiscriminator() from the JAX
    MultiPeriodDiscriminator tree (disc_s/conv_{i}/{kernel,g,bias},
    disc_p{p}/conv_{i}/{kernel,bias}, ...)."""
    with torch.device("meta"):
        model = MultiPeriodDiscriminator()
    return state_dict_from_flax(params, model)


_PRENORM = re.compile(
    r"\b(attn_res|ff_res|self_res|cross_res|ffn_res)\.(\d+)\.[a-z]+\.\2\.")


def _melody_rename(name: str) -> str:
    """'encoder.attn_res.0.attn.0.q.weight' ->
    'encoder.attn_res.0.sublayer.q.weight'."""
    return _PRENORM.sub(r"\1.\2.sublayer.", name)


def melody_state_dicts_from_flax(note_params: dict, duration_params: dict,
                                 cfg: MelodyConfig) -> tuple[dict, dict]:
    """(note model, MSE duration model) state_dicts for the port's
    MelodyTransformer(cfg) and MSEDurationModel(cfg)."""
    with torch.device("meta"):
        notes = MelodyTransformer(cfg)
        durations = MSEDurationModel(cfg)
    return (state_dict_from_flax(note_params, notes, _melody_rename),
            state_dict_from_flax(duration_params, durations,
                                 _melody_rename))


_SUFFIXED = re.compile(r"\b(ln|wi)\.(\d+)\.")


def _suffixed_rename(name: str) -> str:
    """'h.0.ln.1.weight' -> 'h.0.ln_1.weight', 'dec.3.ffn.wi.0.weight' ->
    'dec.3.ffn.wi_0.weight': the port keeps GPT-2's ln_1/ln_2 and T5's
    wi_0/wi_1 as named submodules, not lists."""
    return _SUFFIXED.sub(r"\1_\2.", name)


def t5_state_dict_from_flax(params: dict, cfg: T5Config) -> dict:
    """state_dict for the port's T5(cfg) from the JAX T5 tree."""
    with torch.device("meta"):
        model = T5(cfg)
    return state_dict_from_flax(params, model, _suffixed_rename)


def gpt2_state_dict_from_flax(params: dict, cfg: GPT2Config) -> dict:
    """state_dict for the port's GPT2(cfg) from the JAX GPT2 tree (the LM
    head is tied to wte, so it has no leaf of its own)."""
    with torch.device("meta"):
        model = GPT2(cfg)
    return state_dict_from_flax(params, model, _suffixed_rename)
