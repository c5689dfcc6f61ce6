"""Melody transformer + beam + MSE durations: PyTorch port vs JAX (CPU).

Tiny MelodyConfig (the build_default_song_synthesizer(tiny=True) widths)
over a small lyric dictionary, numpy-seeded weights carried across with
compat.from_jax. Tolerances: teacher-forced log-probs within 1e-5; beam
tokens, generate_song notes and durations identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu_torch.models.melody import transformer as t_tr
from torch_port_util import melody_pair, t

SENTENCES = ["小小的天有大大的梦想", "隐形的翅膀", "带我飞过绝望"]


@pytest.fixture(scope="module")
def pair():
    return melody_pair(SENTENCES)


def test_teacher_forced_logprobs(pair):
    jgen, tgen = pair
    src = np.concatenate([jgen._encode_src(s) for s in SENTENCES])
    rng = np.random.RandomState(3)
    tgt = rng.randint(4, 37, (3, 14)).astype(np.int32)
    src_mask = (src != 0)[:, None, None, :].astype(np.int32)
    want = jax.jit(jgen.note_model.apply)(jgen.note_params, src, tgt,
                                          src_mask, j_tr.causal_mask(14))
    with torch.no_grad():
        got = tgen.note_model(t(src).long(), t(tgt).long(), t(src_mask),
                              t_tr.causal_mask(14))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_prev_sentence_memory(pair):
    jgen, tgen = pair
    src = jgen._encode_src(SENTENCES[1])
    prev = np.zeros((1, 60), np.int32)
    prev[0, :6] = [2, 9, 14, 20, 7, 3]
    src_mask = (src != 0)[:, None, None, :].astype(np.int32)
    want, _ = jax.jit(functools.partial(
        jgen.note_model.apply, method=j_tr.MelodyTransformer.prev_memory))(
            jgen.note_params, src, src_mask, prev)
    with torch.no_grad():
        got, _ = tgen.note_model.prev_memory(t(src).long(), t(src_mask),
                                             t(prev).long(), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_beam_tokens_identical(pair):
    jgen, tgen = pair
    src = jgen._encode_src(SENTENCES[0])
    want, _ = jgen._jit_beam(jgen.note_params, jnp.asarray(src),
                             jnp.zeros((1, 60), jnp.int32), use_prev=False,
                             max_decode=12)
    got = tgen._decode_sentence(t(src).long(), torch.zeros(60).long(), False,
                                12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_song_identical(pair):
    jgen, tgen = pair
    want = jgen.generate_song(SENTENCES)
    got = tgen.generate_song(SENTENCES)
    assert len(got) == len(want) == len(SENTENCES)
    for (gl, gn, gd), (wl, wn, wd) in zip(got, want):
        assert gl == wl
        assert gn == wn
        assert gd == wd


def test_topk_breaks_ties_towards_lower_index():
    from music_generation_tpu_torch.models.melody.beam import topk_lower_index
    x = torch.tensor([1.0, 3.0, 3.0, -1e9, 3.0, 2.0])
    vals, idx = topk_lower_index(x, 4)
    assert idx.tolist() == [1, 2, 4, 5]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()
