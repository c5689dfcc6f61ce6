"""Lyric LMs and their tokenizers: PyTorch port vs JAX (CPU).

Tiny widths (vocab <= 64, 2 layers so the first layer's relative bias is
reused, d_model 32) over tokenizer artifacts the tests write themselves.
Weights: shapes from jax.eval_shape, values from numpy seeds, carried
across with compat.from_jax. The JAX decode loops are jitted, each
compiled once per module. Tolerances: tokenizers, buckets, greedy and
top_k=1 decodes, and both generators' strings identical; teacher-forced
logits within rtol=atol=2e-4 (tests/test_lyrics.py's tolerance).
"""

import base64
import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.models.lyrics import api as j_api
from music_generation_tpu.models.lyrics import gpt2 as j_gpt2
from music_generation_tpu.models.lyrics import spm as j_spm
from music_generation_tpu.models.lyrics import t5 as j_t5
from music_generation_tpu.models.lyrics import tokenizer as j_tok
from music_generation_tpu.models.lyrics import wordpiece as j_wp
from music_generation_tpu_torch.compat import (gpt2_state_dict_from_flax,
                                               t5_state_dict_from_flax)
from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.models.lyrics import api as t_api
from music_generation_tpu_torch.models.lyrics import gpt2 as t_gpt2
from music_generation_tpu_torch.models.lyrics import spm as t_spm
from music_generation_tpu_torch.models.lyrics import t5 as t_t5
from music_generation_tpu_torch.models.lyrics import tokenizer as t_tok
from music_generation_tpu_torch.models.lyrics import wordpiece as t_wp
from music_generation_tpu_torch.serve.app import MusicGenerationService
from torch_port_util import (init_params, same_config, t, tiny_songs,
                             write_spm_model, write_wordpiece_vocab)

TINY_T5 = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_decoder_layers=2, num_heads=4)
KEYWORD = "夏天"
T5_BUDGET = 120          # the default decode budget, min(512, 8 * 15)
TEXTS = ["小小的天有大大的梦想", "Hello, World! 我爱你abc", "<Pop 流行>夏天[SEP]x",
         "  \t关键词：夏天 长度：15  ", "𠀀é", ""]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    return (write_spm_model(d / "spiece.model"),
            write_wordpiece_vocab(d / "vocab.txt"))


@pytest.fixture(scope="module")
def t5_pair(artifacts):
    """(JAX LyricGeneratorT5, port LyricGeneratorT5), same weights, over
    the sentencepiece model with 4 sentinels."""
    jtok = j_spm.T5SentencePieceTokenizer(artifacts[0], extra_ids=4)
    jcfg = j_api.t5_config_for(jtok, **TINY_T5)
    jm = j_t5.T5(jcfg)
    params = init_params(jm, 14, jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32),
                         jnp.zeros((1, 4), jnp.int32))
    jgen = j_api.LyricGeneratorT5(jcfg, params=params, tokenizer=jtok)
    cfg = same_config(t_t5.T5Config, jcfg)
    tgen = t_api.LyricGeneratorT5(
        cfg, tokenizer=t_spm.T5SentencePieceTokenizer(artifacts[0],
                                                      extra_ids=4),
        device="cpu")
    tgen.model.load_state_dict(t5_state_dict_from_flax(params, cfg))
    return jgen, tgen


@pytest.fixture(scope="module")
def gpt2_pair(artifacts):
    """(JAX LyricGeneratorGPT2, port LyricGeneratorGPT2), same weights,
    over the wordpiece vocab."""
    jtok = j_wp.WordPieceTokenizer(artifacts[1])
    jcfg = j_gpt2.GPT2Config(vocab_size=jtok.vocab_size, n_layer=2,
                             n_embd=32, n_head=2, n_positions=128)
    params = init_params(j_gpt2.GPT2(jcfg), 57, jnp.zeros((1, 8), jnp.int32))
    jgen = j_api.LyricGeneratorGPT2(jcfg, params=params, tokenizer=jtok)
    cfg = same_config(t_gpt2.GPT2Config, jcfg)
    tgen = t_api.LyricGeneratorGPT2(
        cfg, tokenizer=t_wp.WordPieceTokenizer(artifacts[1]), device="cpu")
    tgen.model.load_state_dict(gpt2_state_dict_from_flax(params, cfg))
    return jgen, tgen


def _jax_t5_top1(jgen, src):
    return np.asarray(j_t5.topk_sample_generate(
        jgen.model, jgen.params, jax.random.PRNGKey(0), jnp.asarray(src),
        jnp.ones_like(jnp.asarray(src)), max_length=T5_BUDGET, top_k=1))


# ---- tokenizers ------------------------------------------------------------

def test_char_tokenizer_matches_jax():
    j, p = j_tok.CharTokenizer(), t_tok.CharTokenizer()
    assert p.tokens == j.tokens and p.vocab_size == j.vocab_size
    assert (p.pad_id, p.cls_id, p.sep_id, p.eos_id) == \
        (j.pad_id, j.cls_id, j.sep_id, j.eos_id)
    for style in j_tok.STYLE_TOKENS + ("<nope>",):
        assert p.token_id(style) == j.token_id(style)
    for text in TEXTS:
        ids = p.encode(text)
        assert ids == j.encode(text)
        assert p.encode(text, add_eos=True) == j.encode(text, add_eos=True)
        ids = [p.cls_id] + ids + [p.sep_id, p.token_id("<Pop 流行>"),
                                  p.eos_id, p.vocab_size + 5]
        for skip in (False, True):
            assert p.decode(ids, skip_special=skip) == \
                j.decode(ids, skip_special=skip)


def test_wordpiece_matches_jax(artifacts):
    j = j_wp.WordPieceTokenizer(artifacts[1])
    p = t_wp.WordPieceTokenizer(artifacts[1])
    assert p.tokens == j.tokens
    assert (p.pad_id, p.cls_id, p.sep_id, p.eos_id, p.unk_id) == \
        (j.pad_id, j.cls_id, j.sep_id, j.eos_id, j.unk_id)
    for text in TEXTS + ["hellohello world<结束>" + "a" * 120]:
        assert p.tokenize(text) == j.tokenize(text)
        for special in (False, True):
            ids = p.encode(text, add_special_tokens=special)
            assert ids == j.encode(text, add_special_tokens=special)
            for skip in (False, True):
                assert p.decode(ids, skip_special=skip) == \
                    j.decode(ids, skip_special=skip)


def test_sentencepiece_matches_jax(artifacts):
    j = j_spm.T5SentencePieceTokenizer(artifacts[0], extra_ids=4)
    p = t_spm.T5SentencePieceTokenizer(artifacts[0], extra_ids=4)
    assert p.vocab_size == j.vocab_size
    assert (p.pad_id, p.eos_id, p.unk_id) == (j.pad_id, j.eos_id, j.unk_id)
    for token in ("<extra_id_0>", "<extra_id_3>", "夏天", "</s>", "zz"):
        assert p.token_id(token) == j.token_id(token)
    for text in TEXTS:
        assert p.sp.normalize(text) == j.sp.normalize(text)
        assert p.sp.encode_pieces(text) == j.sp.encode_pieces(text)
        ids = p.encode(text, add_eos=True)
        assert ids == j.encode(text, add_eos=True)
        ids = ids + [p.vocab_size - 1, p.pad_id]
        for skip in (False, True):
            assert p.decode(ids, skip_special=skip) == \
                j.decode(ids, skip_special=skip)
            assert p.sp.decode(ids[:-2], skip_special=skip) == \
                j.sp.decode(ids[:-2], skip_special=skip)


# ---- model pieces ----------------------------------------------------------

@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_identical(bidirectional):
    rel = np.arange(-300, 301)
    want = np.asarray(jax.jit(lambda r: j_t5.relative_position_bucket(
        r, bidirectional, 32, 128))(jnp.asarray(rel)))
    got = t_t5.relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                        32, 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_t5_teacher_forced_logits(t5_pair):
    jgen, tgen = t5_pair
    rng = np.random.RandomState(3)
    v = jgen.cfg.vocab_size
    src = rng.randint(1, v, (2, 9)).astype(np.int32)
    mask = np.ones_like(src)
    mask[1, 6:] = 0                      # ragged source
    tgt = rng.randint(1, v, (2, 7)).astype(np.int32)
    want = jax.jit(jgen.model.apply)(jgen.params, src, mask, tgt)
    with torch.no_grad():
        got = tgen.model(t(src).long(), t(mask), t(tgt).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_gpt2_teacher_forced_logits(gpt2_pair):
    jgen, tgen = gpt2_pair
    ids = np.random.RandomState(4).randint(
        0, jgen.cfg.vocab_size, (2, 13)).astype(np.int32)
    want = jax.jit(jgen.model.apply)(jgen.params, ids)
    with torch.no_grad():
        got = tgen.model(t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_t5_cached_decode_matches_forward(t5_pair):
    model = t5_pair[1].model
    cfg = model.cfg
    rng = np.random.RandomState(5)
    src = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 9)))
    mask = torch.ones_like(src)
    mask[0, 7:] = 0
    tgt = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        full = model(src, mask, tgt)
        cross = model.cross_kv(model.encode(src, mask))
        caches = t_t5.init_t5_cache(cfg, 2, 8)
        table = model.dec[0].self_attn.compute_bias(8, 8)
        steps = []
        for pos in range(8):
            row = model.decoder_bias_row(pos, 8)
            assert torch.equal(row, table[:, :, pos])
            logits, caches = model.decode_step(tgt[:, pos], pos, cross, mask,
                                               caches, row)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_gpt2_cached_decode_matches_forward(gpt2_pair):
    model = gpt2_pair[1].model
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, model.cfg.vocab_size, (2, 10)))
    with torch.no_grad():
        full = model(ids)
        caches = t_gpt2.init_cache(model.cfg, 2, 10)
        steps = []
        for pos in range(10):
            logits, caches = model.decode_step(ids[:, pos], pos, caches)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ban_repeated_bigrams_identical():
    rng = np.random.RandomState(8)
    vocab = 12
    tokens = rng.randint(0, vocab, (4, 24)).astype(np.int32)
    logits = rng.randn(4, vocab).astype(np.float32)
    jban = jax.jit(j_gpt2._ban_repeated_bigrams, static_argnums=3)
    banned = 0
    for step in range(tokens.shape[1]):
        want = np.asarray(jban(logits, tokens, step, vocab))
        got = t_gpt2._ban_repeated_bigrams(t(logits), t(tokens).long(), step,
                                           vocab).numpy()
        np.testing.assert_array_equal(got, want)
        banned += int((want < -1e8).sum())
    assert banned > 0


# ---- decodes ---------------------------------------------------------------

def test_gpt2_greedy_identical(gpt2_pair):
    jgen, tgen = gpt2_pair
    tok = tgen.tokenizer
    prompts = [[tok.cls_id] + tok.encode(title) + [tok.sep_id,
                                                  tok.token_id(style),
                                                  tok.sep_id]
               for title, style in (("夏天", "<Pop 流行>"),
                                    ("我爱你的歌", "<Folk 民谣>"))]
    buf = np.full((2, 90), tok.pad_id, np.int32)
    for i, p in enumerate(prompts):
        buf[i, : len(p)] = p
    plen = np.array([len(p) for p in prompts], np.int32)
    want = np.asarray(j_gpt2.greedy_generate(
        jgen.model, jgen.params, jnp.asarray(buf), jnp.asarray(plen),
        max_length=90))
    got = t_gpt2.greedy_generate(tgen.model, t(buf), t(plen), max_length=90)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, p in enumerate(prompts):   # the prompts' own tokens stay
        np.testing.assert_array_equal(got[i, : len(p)].numpy(), p)


def test_t5_top1_decode_identical(t5_pair):
    """Greedy (top_k=1) decodes agree token for token; the buffer holds
    EOS, pad after it, and the bigram ban changed the decode."""
    jgen, tgen = t5_pair
    cfg = tgen.cfg
    src = np.asarray([tgen.prompt_ids(KEYWORD)], np.int32)
    want = _jax_t5_top1(jgen, src)
    gen = torch.Generator().manual_seed(0)
    got = t_t5.topk_sample_generate(tgen.model, gen, t(src).long(),
                                    torch.ones(src.shape, dtype=torch.int64),
                                    max_length=T5_BUDGET, top_k=1).numpy()
    np.testing.assert_array_equal(got, want)
    row = got[0].tolist()
    assert cfg.eos_token_id in row[1:-1]
    end = row.index(cfg.eos_token_id)
    assert all(i == cfg.pad_token_id for i in row[end + 1:])
    unbanned = t_t5.topk_sample_generate(
        tgen.model, gen, t(src).long(), torch.ones(src.shape,
                                                   dtype=torch.int64),
        max_length=T5_BUDGET, top_k=1, no_repeat_ngram=0).numpy()
    assert not np.array_equal(unbanned, got)


def test_t5_topk_sampling(t5_pair):
    """The port's sampler: one seed, one draw; each drawn token is among
    the step's k best (after the bigram ban); pad follows EOS."""
    model = t5_pair[1].model
    cfg = model.cfg
    k, steps = 5, 48
    src = torch.tensor([t5_pair[1].prompt_ids(KEYWORD)] * 4)
    mask = torch.ones_like(src)

    def draw(seed):
        return t_t5.topk_sample_generate(
            model, torch.Generator().manual_seed(seed), src, mask,
            max_length=steps, top_k=k)

    out = draw(123)
    assert torch.equal(out, draw(123))
    assert not torch.equal(out, draw(124))
    buf = torch.cat([torch.full((4, 1), cfg.decoder_start_token_id), out], 1)
    with torch.no_grad():
        logits = model(src, mask, buf[:, :-1])
    ended = 0
    for b in range(4):
        row = out[b].tolist()
        end = row.index(cfg.eos_token_id) if cfg.eos_token_id in row \
            else steps - 1
        ended += end < steps - 1
        assert all(i == cfg.pad_token_id for i in row[end + 1:])
        for pos in range(end + 1):
            step_logits = t_gpt2._ban_repeated_bigrams(
                logits[b: b + 1, pos], buf[b: b + 1], pos, cfg.vocab_size)
            assert row[pos] in step_logits.topk(k).indices[0].tolist()
    assert ended > 0


# ---- the slice as a whole --------------------------------------------------

def test_lyric_generator_gpt2_matches_jax(gpt2_pair):
    jgen, tgen = gpt2_pair
    for title, style in ((KEYWORD, "<Pop 流行>"),
                         ("我爱你", "<Rock 摇滚 & Metal 金属>")):
        want = jgen.generate(title, style)
        assert tgen.generate(title, style) == want
        assert want  # the post-processing kept generated segments


def _greedy_t5(monkeypatch):
    """Both generators' T5 sampling at top_k=1, where it is greedy."""
    monkeypatch.setattr(j_api, "T5_TOP_K", 1)
    monkeypatch.setattr(t_api, "T5_TOP_K", 1)


def test_lyric_generator_t5_top1_matches_jax(t5_pair, monkeypatch):
    jgen, tgen = t5_pair
    _greedy_t5(monkeypatch)
    want = jgen.generate(KEYWORD)
    assert tgen.generate(KEYWORD) == want
    assert want


@pytest.mark.parametrize("family", ["t5", "gpt2"])
def test_keyword_request_through_service(family, t5_pair, gpt2_pair,
                                         tmp_path, monkeypatch):
    """A keyword request answers 200 with the lyrics the JAX generator
    writes (T5 at top_k=1) and a WAV of them."""
    jgen, tgen = t5_pair if family == "t5" else gpt2_pair
    _greedy_t5(monkeypatch)
    want = jgen.generate(KEYWORD).replace("-", "")
    service = MusicGenerationService(
        tiny_songs(), tgen, ServiceConfig(log_dir=str(tmp_path)))
    try:
        out = service.handle_synthesis({"keyword": KEYWORD})
    finally:
        service.close()
    assert out["code"] == 200, out
    assert out["data"]["lyrics"] == want
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16
    assert len(wav) > int(0.2 * 22050) and np.any(wav != 0)


def test_flax_conversion_is_strict(t5_pair, gpt2_pair):
    params = copy.deepcopy(t5_pair[0].params)
    cfg = t5_pair[1].cfg
    params["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unconsumed"):
        t5_state_dict_from_flax(params, cfg)
    params = copy.deepcopy(gpt2_pair[0].params)
    del params["params"]["h_1"]["ln_2"]
    with pytest.raises(ValueError, match="unfilled"):
        gpt2_state_dict_from_flax(params, gpt2_pair[1].cfg)
