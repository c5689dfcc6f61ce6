"""Seq2seq melody family (melody_v2): PyTorch port vs JAX.

The encoder (GRU and LSTM, bidirectional, sources of two lengths in one
batch), the teacher-forced Seq2SeqModel, beam_decode and
Seq2SeqMelodyGenerator.get_melody against their flax twins at tiny widths,
with numpy-seeded weights carried across by
compat.seq2seq_state_dict_from_flax. Tolerances: 1e-5 for activations and
log-probs (float32 sums in another order); decoded tokens, melodies and
vocabularies identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.models.melody import seq2seq as j_s2s
from music_generation_tpu.models.melody import seq2seq_api as j_api
from music_generation_tpu.serve import variants as j_var
from music_generation_tpu_torch.compat import seq2seq_state_dict_from_flax
from music_generation_tpu_torch.models.melody import seq2seq as t_s2s
from music_generation_tpu_torch.models.melody import seq2seq_api as t_api
from music_generation_tpu_torch.serve import variants as t_var
from torch_port_util import _shapes_only_init, random_params, same_config, t

TOL = 1e-5
TINY = dict(en_vocab=30, de_vocab=20, en_embedding_dim=16,
            de_embedding_dim=16, hidden_dim=16)
CELLS = {"gru": dict(use_lstm=False), "lstm": dict(use_lstm=True),
         "gru_2layer": dict(num_layers=2)}
SRC = np.array([[5, 6, 7, 8, 9, 10, 2, 0],       # length 7
                [11, 12, 13, 2, 0, 0, 0, 0]],    # length 4
               np.int32)
TGT = np.array([[3, 5, 6, 7, 8], [3, 9, 10, 11, 12]], np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _pair(cell: str, seed: int = 0, **overrides):
    """(jax model, params, port model) with the same random weights."""
    fields = {**TINY, **CELLS[cell], **overrides}
    jcfg = j_s2s.Seq2SeqConfig(**fields)
    jm = j_s2s.Seq2SeqModel(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 2), jnp.int32)))
    params = random_params(shapes, seed)
    cfg = same_config(t_s2s.Seq2SeqConfig, jcfg)
    port = t_s2s.Seq2SeqModel(cfg)
    port.load_state_dict(seq2seq_state_dict_from_flax(params, cfg))
    return jm, params, port.eval()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_encoder_matches_jax(cell):
    """Outputs at each source's valid positions and the final carry (h,
    or an LSTM's cell state): the reverse direction starts at each
    source's own last token, not at the padding."""
    jm, params, port = _pair(cell)
    lengths = (SRC != 0).sum(1)
    want_out, want_h = jm.apply(params, SRC, lengths,
                                method=j_s2s.Seq2SeqModel.encode)
    with torch.no_grad():
        got_out, got_h = port.encoder(t(SRC).long(), t(lengths))
    valid = (np.arange(SRC.shape[1])[None] < lengths[:, None])
    _close(got_out.numpy()[valid], np.asarray(want_out)[valid])
    _close(got_h, want_h)
    assert got_out.shape == want_out.shape


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_teacher_forced_matches_jax(cell):
    jm, params, port = _pair(cell, seed=1)
    want = jm.apply(params, SRC, TGT)
    with torch.no_grad():
        got = port(t(SRC).long(), t(TGT).long())
    _close(got, want)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_decode_matches_jax(cell):
    """Tokens identical and the best score within 1e-5, on a source with
    right-padding and one without. The output projection is scaled up so
    the beams part: the GRU decodes varied tokens, the LSTM reaches EOS
    mid-way (its finished beams then stay on PAD)."""
    jm, params, _ = _pair(cell, seed=3, de_vocab=12)
    params["params"]["decoder"]["linear2"]["kernel"] *= 4.0
    port = t_s2s.Seq2SeqModel(t_s2s.Seq2SeqConfig(**{**TINY, **CELLS[cell],
                                                     "de_vocab": 12}))
    port.load_state_dict(seq2seq_state_dict_from_flax(params, port.cfg))
    tokens = []
    for src in (SRC[:1], SRC[1:, :4]):
        want_seq, want_score = j_s2s.beam_decode(jm, params, jnp.asarray(src),
                                                 max_len=8, beam=5)
        got_seq, got_score = t_s2s.beam_decode(port.eval(), t(src).long(),
                                               max_len=8, beam=5)
        np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
        _close(got_score, want_score)
        tokens += got_seq.tolist()
    assert len(set(tokens) - {t_s2s.PAD_ID, t_s2s.EOS_ID}) >= 2
    assert (t_s2s.EOS_ID in tokens) == (cell == "lstm")


def test_mapper_refuses_unconsumed_leaves():
    jm, params, port = _pair("gru")
    params = {"params": {**params["params"],
                         "extra": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="extra"):
        seq2seq_state_dict_from_flax(params, port.cfg)


def test_langs_match_jax():
    lang = t_s2s.Lang(["C4", "D4"])
    assert lang.encode(["C4", "zzz"]) == [4, 1]
    assert lang.decode([4, 99]) == ["C4", "_UNK_"]
    for mine, theirs in zip(t_api.default_langs(), j_api.default_langs()):
        assert mine.item2index == theirs.item2index
        assert mine.index2item == theirs.index2item


@pytest.fixture(scope="module")
def generators():
    """The JAX and port Seq2SeqMelodyGenerator with the same three sets of
    weights. On both sides the output projection is scaled up, the bias of
    PAD/UNK/START set to -10 (the port's random init) and EOS's to -3, so
    the decodes give varied real notes and duration tokens."""
    lyric = j_s2s.Lang(list("小天有大的梦想你好世界"))
    note = j_s2s.Lang(["C4", "D4", "E4", "G4", "rest"])
    dur = j_s2s.Lang(["0.2000", "0.3000", "0.4202", "0.5000", "0.6000"])
    jcfg = j_s2s.Seq2SeqConfig(en_embedding_dim=16, de_embedding_dim=16,
                               hidden_dim=16, num_layers=1)
    with _shapes_only_init(j_s2s.Seq2SeqModel):
        jgen = j_api.Seq2SeqMelodyGenerator(lyric, note, dur, cfg=jcfg,
                                            seed=3)
    tgen = t_api.Seq2SeqMelodyGenerator(
        *(t_s2s.Lang(list(x.item2index)[4:]) for x in (lyric, note, dur)),
        cfg=same_config(t_s2s.Seq2SeqConfig, jcfg),
        seed=3, device="cpu")
    for k, name in enumerate(("lyric2note", "lyric2duration",
                              "note2duration")):
        model, shapes = getattr(jgen, name)
        params = random_params(shapes, 30 + k)
        head = params["params"]["decoder"]["linear2"]
        head["kernel"] *= 3.0
        head["bias"][[t_s2s.PAD_ID, t_s2s.UNK_ID, t_s2s.START_ID]] = -10.0
        head["bias"][t_s2s.EOS_ID] = -3.0
        setattr(jgen, name, (model, params))
        port = getattr(tgen, name)
        port.load_state_dict(seq2seq_state_dict_from_flax(params, port.cfg))
    return jgen, tgen


@pytest.mark.parametrize("lyrics", ["小天，有大的梦想", "小小的天有大大的梦想",
                                    "你好世界"],
                         ids=["comma", "breath", "short"])
def test_get_melody_matches_jax(generators, lyrics):
    """get_melody identical: the comma branch (SP/AP pairs), the breath
    branch (a line over 6 characters, the breath drawn from
    random.Random(seed) on both sides) and a short line; then the
    variant adapter's MIDI tokens."""
    jgen, tgen = generators
    want = jgen.get_melody(lyrics)
    assert tgen.get_melody(lyrics) == want
    assert len(want[1]) == len(want[2])
    assert len(set(want[1]) - {"rest"}) >= 2
    assert ("SP" in want[0]) == (lyrics != "你好世界")
    assert j_var._Seq2SeqAdapter(jgen).generate(lyrics) == \
        t_var._Seq2SeqAdapter(tgen).generate(lyrics)
