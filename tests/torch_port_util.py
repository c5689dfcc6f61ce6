"""Shared helpers of the tests/test_torch_*.py parity tests.

Parameters come from numpy seeds: a flax module's parameter shapes are
traced with jax.eval_shape (no JAX init compute) and filled with
unit-scale random values, which also replaces the zero-init flow
projections and the 1e-4-scale HiFi-GAN output conv that would otherwise
hide errors. The same tree goes to the JAX module and, through the port's
compat.from_jax, to its PyTorch twin.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from music_generation_tpu.models.melody import api as j_api
from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.models.melody.vocab import (
    lyric_dictionary_from_chars, note_dictionary)
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu_torch.compat import (melody_state_dicts_from_flax,
                                               visinger_state_dict_from_flax)
from music_generation_tpu_torch.models.melody import api as t_api
from music_generation_tpu_torch.models.melody import transformer as t_tr
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.pipeline.synthesis import (
    build_default_song_synthesizer, tiny_configs)

# The tiny-width port tests run no faster on several intra-op threads, and
# under pytest-xdist those threads take cores from the other workers.
torch.set_num_threads(1)

# tiny SVS batch: B sentences of T phones, F frames
B, T, F = 2, 16, 128
X_LEN = np.array([16, 11], np.int32)


def random_params(shape_tree, seed: int):
    """Unit-scale random numpy values for every leaf of a shape tree."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shape_tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "g":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        else:  # embeddings and relative-position tables
            v = rng.randn(*shape) / np.sqrt(shape[-1])
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def init_params(module, seed: int, *args, method=None, **kwargs):
    """Random params for a flax module, shapes from eval_shape."""
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(
        lambda: module.init(rngs, *args, method=method, **kwargs))
    return random_params(shapes, seed)


def _shapes_only_init(cls):
    """Patch ``cls.init`` to trace shapes only (jax.eval_shape, nothing
    computed): for a constructor whose initial parameters the test
    replaces anyway."""
    init = cls.init

    def shapes(self, *args, **kwargs):
        return jax.eval_shape(lambda: init(self, *args, **kwargs))
    return mock.patch.object(cls, "init", shapes)


def same_config(target_cls, source_cfg):
    """A ``target_cls`` config with ``source_cfg``'s values for the fields
    the two share (the port's configs hold a subset of the JAX fields)."""
    return target_cls(**{f.name: getattr(source_cfg, f.name)
                         for f in dataclasses.fields(target_cls)
                         if hasattr(source_cfg, f.name)})


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def svs_score(seed=0):
    rng = np.random.RandomState(seed)
    ids = lambda hi: rng.randint(1, hi, (B, T)).astype(np.int32)  # noqa: E731
    return dict(phones=ids(60), note_ids=ids(90), shengdiao=ids(240),
                note_durations=rng.uniform(0.1, 0.5, (B, T)).astype(
                    np.float32), x_lengths=X_LEN)


def visinger_pair(seed=0):
    """(jax model, params, port model) with the same random weights."""
    _, cfg = tiny_configs(100)
    jcfg = same_config(jv.SVSConfig, cfg)
    jm = jv.VISinger(jcfg)
    params = init_params(jm, seed, **svs_score(), max_frames=F,
                         method=jv.VISinger.infer)
    params["params"]["spec_encoder"] = init_params(
        jv.PosteriorEncoder(jcfg), seed + 1, jnp.zeros((1, 8, 65)),
        jnp.ones((1, 8, 1)))["params"]
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg))
    return jm, params, port.eval()


def melody_pair(sentences, seed=0, audible=False):
    """(jax MelodyGenerator, port MelodyGenerator) with the same numpy-
    seeded weights. ``audible`` biases the heads as the port's own init
    does: PAD/UNK/BOS logits at -10 (random weights then emit pitches) and
    durations near 0.3 s (log(1 + 30 centiseconds))."""
    lyric = lyric_dictionary_from_chars("".join(sentences))
    notes = note_dictionary()
    jcfg = j_tr.MelodyConfig(src_vocab=lyric.size, tgt_vocab=notes.size,
                             n_layers=1, d_model=32, d_ff=64, n_heads=2)
    with _shapes_only_init(j_tr.MelodyTransformer), \
            _shapes_only_init(j_tr.MSEDurationModel):
        jgen = j_api.MelodyGenerator(lyric, notes, cfg=jcfg)
    jgen.note_params = random_params(jgen.note_params, seed)
    jgen.duration_params = random_params(jgen.duration_params, seed + 1)
    if audible:
        jgen.note_params["params"]["generator"]["bias"][:3] = -10.0
        jgen.duration_params["params"]["generator"]["bias"][:] = \
            np.log1p(30.0)
    cfg = same_config(t_tr.MelodyConfig, jcfg)
    tgen = t_api.MelodyGenerator(lyric, notes, cfg=cfg, device="cpu")
    note_sd, dur_sd = melody_state_dicts_from_flax(
        jgen.note_params, jgen.duration_params, cfg)
    tgen.note_model.load_state_dict(note_sd)
    tgen.duration_model.load_state_dict(dur_sd)
    return jgen, tgen


@functools.lru_cache(maxsize=None)
def tiny_songs():
    """The tiny random song synthesizer on the CPU (one singer), built once
    per process and shared by the service tests."""
    return build_default_song_synthesizer(tiny=True, n_speakers=1,
                                          device="cpu")


# ---- tokenizer artifacts the lyric tests write themselves ----------------

LYRIC_CHARS = "的我你风花雪月爱梦想飞歌春秋海山云雨星光心天夏"


def write_wordpiece_vocab(path) -> str:
    """A BERT vocab.txt small enough for a vocab-64 model (the GPT-2
    wordpiece tokenizer adds its 8 style/EOS tokens on top)."""
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "，", "。", "!",
               "he", "##llo", "##l", "##o", "wor", "##ld", "a", "b"]
              + list(LYRIC_CHARS) + ["关", "键", "词"])
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return str(path)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int, payload) -> bytes:
    key = _varint(num << 3 | wire)
    if wire == 0:
        return key + _varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + _varint(len(payload)) + payload


def write_spm_model(path) -> str:
    """A sentencepiece unigram ModelProto written field by field: T5's
    special layout (pad 0 and eos 1 as CONTROL, unk 2), scored NORMAL
    pieces with multi-character ones, TrainerSpec.model_type=1, no
    precompiled charsmap."""
    rng = np.random.RandomState(7)
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁", -2.0, 1), ("关键词", -3.0, 1), ("长度", -3.5, 1),
              ("15", -4.0, 1), ("夏天", -4.5, 1), ("▁关键词", -2.5, 1)]
    pieces += [(ch, float(-5.0 - rng.rand() * 3), 1)
               for ch in "关键词长度夏天：1523" + LYRIC_CHARS.replace("天", "")
               .replace("夏", "")]
    blob = b"".join(_field(1, 2, _field(1, 2, p.encode()) + _field(2, 5, s)
                           + _field(3, 0, t)) for p, s, t in pieces)
    blob += _field(2, 2, _field(3, 0, 1) + _field(40, 0, 2)
                   + _field(42, 0, 1) + _field(43, 0, 0))
    blob += _field(3, 2, _field(3, 0, 1) + _field(4, 0, 1) + _field(5, 0, 1))
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)
