"""Carry the JAX package's parameter trees over to the port's modules.

The trees come in as nested dicts of numpy arrays (flax's ``params``
collection, with or without the outer ``{"params": ...}``); this module
imports no JAX. Layouts:
  - conv             [K, I, O] -> [O, I, K]
  - 2-D conv         [H, W, I, O] (HWIO) -> [O, I, H, W]
  - transposed conv  [K, I, O] -> flipped along K, then [I, O, K]
  - dense            [in, out] -> [out, in]
  - weight norm: (kernel, g) kept as is (the port stores the same pair)
  - speaker conditioning: the ``cond`` convs flax builds when a module is
    first called with g (the WaveNets of spec_encoder and spec_flow, the
    decoder) map onto the ``cond`` convs the port builds for
    ``gin_channels`` > 0
  - flax GRU/LSTM cells: per-gate dense kernels stacked into torch's
    weight_ih / weight_hh (gates r|z|n, i|f|g|o), the biases flax lacks
    set to zero
Every leaf must be consumed and every parameter of the port module filled,
with matching shapes; anything else raises (``strict=False`` allows
unfilled parameters, which compat.checkpoints.load_params then keeps at
their init).
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
from ..models.melody.seq2seq import Seq2SeqConfig, Seq2SeqModel
from ..models.melody.transformer import (MelodyConfig, MelodyTransformer,
                                         MSEDurationModel, SDPDurationConfig,
                                         SDPDurationModel)
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
                         rename: Callable[[str], str] = lambda n: n,
                         strict: bool = True) -> dict:
    """state_dict for ``model`` from the matching flax tree (any port
    module whose submodule names follow the JAX package's); with
    ``strict`` False the tree may lack parameters."""
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
        # a C-ordered copy: a transposed view's strides would follow the
        # tensor (an optimizer moment built from it pairs with the wrong
        # weights)
        state[name] = torch.from_numpy(np.array(out, order="C"))
    missing = sorted(set(targets) - set(state)) if strict else []
    if unknown or missing:
        raise ValueError(f"unconsumed leaves: {unknown}; "
                         f"unfilled parameters: {missing}")
    return state


def visinger_state_dict_from_flax(params: dict, cfg: SVSConfig,
                                  strict: bool = True) -> dict:
    """state_dict for the port's VISinger(cfg) from the JAX VISinger tree,
    the decoder of ``cfg.decoder_type`` included (an iSTFT tree's
    decoder/istft_head too), without spec_decoder and spec_proj when
    ``cfg.autoencoder`` is False, with the cond convs when
    ``cfg.gin_channels`` > 0. Strict, the tree must hold every submodule,
    spec_encoder included; the tree a JAX SVSSynthesizer serves (initialised
    through infer) has no spec_encoder, and flax creates the cond convs
    only in a tree initialised through a call with g (voice_conversion), so
    such trees convert with ``strict`` False."""
    with torch.device("meta"):
        model = VISinger(cfg)
    return state_dict_from_flax(params, model, strict=strict)


def mpd_state_dict_from_flax(params: dict) -> dict:
    """state_dict for the port's MultiPeriodDiscriminator() from the JAX
    MultiPeriodDiscriminator tree (disc_s/conv_{i}/{kernel,g,bias},
    disc_p{p}/conv_{i}/{kernel,bias}, ...)."""
    with torch.device("meta"):
        model = MultiPeriodDiscriminator()
    return state_dict_from_flax(params, model)


_PRENORM = re.compile(
    r"\b(attn_res|ff_res|self_res|cross_res|ffn_res)\.(\d+)\.[a-z]+\.\2\.")


def melody_rename(name: str) -> str:
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
    return (state_dict_from_flax(note_params, notes, melody_rename),
            state_dict_from_flax(duration_params, durations,
                                 melody_rename))


def telemelody_state_dicts_from_flax(l2r_params: dict, t2m_params: dict,
                                     l2r_cfg: MelodyConfig,
                                     t2m_cfg: MelodyConfig
                                     ) -> tuple[dict, dict]:
    """(lyric2rhythm, trend2melody) state_dicts for the port's
    TeleMelodyGenerator twins, MelodyTransformer(l2r_cfg) and
    MelodyTransformer(t2m_cfg), through the melody mapper."""
    out = []
    for params, cfg in ((l2r_params, l2r_cfg), (t2m_params, t2m_cfg)):
        with torch.device("meta"):
            model = MelodyTransformer(cfg)
        out.append(state_dict_from_flax(params, model, melody_rename))
    return out[0], out[1]


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


def sdp_state_dict_from_flax(params: dict, cfg: SDPDurationConfig,
                             nll: bool = False) -> dict:
    """state_dict for the port's SDPDurationModel(cfg, nll). The tree
    flax builds with init(method=infer_duration) holds exactly what
    inference runs; a tree from the training __call__ also holds the
    duration predictor's flow 0 and posterior (dp/flow_0, dp/post_*),
    which only the NLL direction uses. With ``nll`` every leaf is carried
    (the training model); without it those subtrees, and only those, are
    dropped."""
    params = dict(params.get("params", params))
    if not nll:
        params["dp"] = {k: v for k, v in params["dp"].items()
                        if k != "flow_0" and not k.startswith("post_")}
    with torch.device("meta"):
        model = SDPDurationModel(cfg, nll=nll)
    return state_dict_from_flax(params, model)


_GRU_GATES = (("ir", "iz", "in"), ("hr", "hz", "hn"))
_LSTM_GATES = (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"))


def _rnn_cell(leaves: dict, prefix: str, use_lstm: bool) -> dict:
    """torch (weight_ih, weight_hh, bias_ih, bias_hh) of one flax cell,
    popping its leaves from ``leaves`` ('prefix/gate/kernel|bias'). A gate
    flax keeps unbiased (the GRU's hr and hz, the LSTM's input gates) gets
    a zero bias."""
    out = {}
    for side, gates in zip(("ih", "hh"),
                           _LSTM_GATES if use_lstm else _GRU_GATES):
        kernels = [leaves.pop(f"{prefix}/{g}/kernel") for g in gates]
        out[f"weight_{side}"] = np.concatenate([k.T for k in kernels])
        out[f"bias_{side}"] = np.concatenate([
            leaves.pop(f"{prefix}/{g}/bias", np.zeros(k.shape[1], np.float32))
            for g, k in zip(gates, kernels)])
    return out


def seq2seq_state_dict_from_flax(params: dict, cfg: Seq2SeqConfig) -> dict:
    """state_dict for the port's Seq2SeqModel(cfg) from one JAX
    Seq2SeqModel tree (Seq2SeqMelodyGenerator holds three: one call per
    model)."""
    leaves = {"/".join(k): v for k, v in
              _flatten(params.get("params", params))}
    named = {"encoder.embed.weight": leaves.pop("encoder/embed/embedding"),
             "decoder.embed.weight": leaves.pop("decoder/embed/embedding")}
    for lin in ("linear1", "linear2"):
        named[f"decoder.{lin}.weight"] = leaves.pop(
            f"decoder/{lin}/kernel").T
        named[f"decoder.{lin}.bias"] = leaves.pop(f"decoder/{lin}/bias")
    for i in range(cfg.num_layers):
        for tag, suffix in (("f", ""), ("b", "_reverse")):
            cell = _rnn_cell(leaves, f"encoder/cell_{tag}{i}", cfg.use_lstm)
            named.update({f"encoder.rnn.{k}_l{i}{suffix}": v
                          for k, v in cell.items()})
        cell = _rnn_cell(leaves, f"decoder/cell_{i}", cfg.use_lstm)
        named.update({f"decoder.cell.{i}.{k}": v for k, v in cell.items()})
    with torch.device("meta"):
        targets = dict(Seq2SeqModel(cfg).named_parameters())
    missing = sorted(set(targets) - set(named))
    if leaves or missing or set(named) - set(targets):
        raise ValueError(f"unconsumed leaves: {sorted(leaves)}; unfilled "
                         f"parameters: {missing}; unknown: "
                         f"{sorted(set(named) - set(targets))}")
    for name, value in named.items():
        if tuple(value.shape) != tuple(targets[name].shape):
            raise ValueError(f"{name}: shape {value.shape} != "
                             f"{tuple(targets[name].shape)}")
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in named.items()}
