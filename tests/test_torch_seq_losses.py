"""The sequence-model objectives of the PyTorch port against the JAX
package's train/seq_losses.py, at tiny widths on the CPU.

Each of the eight family losses and its gradients is held against JAX on
the same numpy-seeded weights (carried across by compat.from_jax) and the
same batch (the port's batcher), the training path taken (deterministic
False) with every dropout rate 0: the port's configs set it, and on the
JAX side flax's Dropout is the identity (the SDP's 0.5 is a constant
there). Losses agree within 1e-5 relative; each gradient leaf within 1e-4
of the JAX leaf's max-abs, mapped through the same converter (positions
the flax tree lacks, the GRU biases flax has none of, are left out). Also
here: cross_entropy, the SDP's NLL on the same posterior noise, the
concat-mode previous-sentence memory, dropout, and the optimizer against
optax over three steps. The JAX side is jitted with XLA's backend
optimisation off.
"""

from __future__ import annotations

import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_generation_tpu.models.lyrics import gpt2 as j_gpt2
from music_generation_tpu.models.lyrics import t5 as j_t5
from music_generation_tpu.models.lyrics.api import \
    t5_config_for as j_t5_config_for
from music_generation_tpu.models.melody import seq2seq as j_s2s
from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.train import seq_losses as jl
from music_generation_tpu_torch.compat import (gpt2_state_dict_from_flax,
                                               seq2seq_state_dict_from_flax,
                                               t5_state_dict_from_flax)
from music_generation_tpu_torch.compat.from_jax import (
    melody_rename, sdp_state_dict_from_flax, state_dict_from_flax)
from music_generation_tpu_torch.core.layers import dropout
from music_generation_tpu_torch.models.lyrics import gpt2 as t_gpt2
from music_generation_tpu_torch.models.lyrics import t5 as t_t5
from music_generation_tpu_torch.models.melody import seq2seq as t_s2s
from music_generation_tpu_torch.models.melody import transformer as t_tr
from music_generation_tpu_torch.train import seq as t_seq
from music_generation_tpu_torch.train import seq_losses as tl
from torch_port_util import init_params, rel_err, same_config, t

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BS = 2


def run_jax(fn, *args):
    """fn(*args) jitted with XLA's backend optimisations off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _no_dropout():
    """flax's Dropout as the identity: rate 0 for every JAX dropout."""
    return mock.patch.object(fnn.Dropout, "__call__",
                             lambda self, x, *a, **k: x)


def _jax_normal(e_q):
    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == e_q.shape
        return jnp.asarray(e_q, dtype)
    return mock.patch.object(jax.random, "normal", normal)


def _batch(family, seed=0):
    """The port batcher's numpy batch (tiny family)."""
    _, _, batcher = t_seq.build_family(family, True, None, seed, "cpu")
    return batcher.batch(BS)


def _melody_cfgs(prev_mode="reference"):
    from music_generation_tpu_torch.frontend import load_lexicon
    from music_generation_tpu_torch.models.melody import (
        lyric_dictionary_from_chars, note_dictionary)
    ld = lyric_dictionary_from_chars(
        sorted(load_lexicon().monosyllable.keys()))
    jcfg = j_tr.MelodyConfig(src_vocab=ld.size,
                             tgt_vocab=note_dictionary().size, n_layers=1,
                             d_model=32, d_ff=64, n_heads=2, dropout=0.0,
                             prev_mode=prev_mode)
    return jcfg, same_config(t_tr.MelodyConfig, jcfg)


def case_melody_note():
    b = _batch("melody_note")
    jcfg, cfg = _melody_cfgs()
    jm = j_tr.MelodyTransformer(jcfg)
    src = jnp.asarray(b["src"])
    params = init_params(jm, 1, src, jnp.asarray(b["tgt_in"]),
                         (src != 0)[:, None, None, :].astype(jnp.int32),
                         j_tr.causal_mask(b["tgt_in"].shape[1]))
    port = t_tr.MelodyTransformer(cfg)
    return (jl.melody_note_loss, jm, params, tl.melody_note_loss, port,
            lambda p: state_dict_from_flax(p, port, melody_rename), b)


def case_melody_note_prev():
    b = _batch("melody_note_prev")
    jcfg, cfg = _melody_cfgs("concat")
    jm = j_tr.MelodyTransformer(jcfg)
    src = jnp.asarray(b["src"])
    params = init_params(jm, 2, src, jnp.asarray(b["tgt_in"]),
                         (src != 0)[:, None, None, :].astype(jnp.int32),
                         j_tr.causal_mask(b["tgt_in"].shape[1]))
    port = t_tr.MelodyTransformer(cfg)
    return (jl.melody_note_prev_loss, jm, params, tl.melody_note_prev_loss,
            port, lambda p: state_dict_from_flax(p, port, melody_rename), b)


def case_duration_mse():
    b = _batch("duration_mse")
    jcfg, cfg = _melody_cfgs()
    jm = j_tr.MSEDurationModel(jcfg)
    src = jnp.asarray(b["src"])
    params = init_params(jm, 3, src,
                         (src != 0)[:, None, None, :].astype(jnp.int32))
    port = t_tr.MSEDurationModel(cfg)
    return (jl.duration_mse_loss, jm, params, tl.duration_mse_loss, port,
            lambda p: state_dict_from_flax(p, port, melody_rename), b)


def _sdp_cfgs():
    from music_generation_tpu_torch.frontend import load_lexicon
    from music_generation_tpu_torch.models.melody import \
        lyric_dictionary_from_chars
    n = lyric_dictionary_from_chars(
        sorted(load_lexicon().monosyllable.keys())).size
    jcfg = j_tr.SDPDurationConfig(src_vocab=n, hidden_dim=16, n_layers=1,
                                  n_heads=2, pf_dim=32, dropout=0.0)
    return jcfg, same_config(t_tr.SDPDurationConfig, jcfg)


def zero_dropout(module):
    """Every dropout rate of ``module`` set to 0 (the SDP's 0.5 is a
    constant, as in JAX)."""
    for m in module.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return module


def case_duration_sdp():
    b = _batch("duration_sdp")
    b["e_q"] = np.random.RandomState(4).randn(BS, b["src"].shape[1], 2) \
        .astype(np.float32)
    jcfg, cfg = _sdp_cfgs()
    jm = j_tr.SDPDurationModel(jcfg)
    params = init_params(jm, 4, jnp.asarray(b["src"]),
                         jnp.asarray(b["durations_cs"]))
    port = zero_dropout(t_tr.SDPDurationModel(cfg, nll=True))
    return (jl.duration_sdp_loss, jm, params, tl.duration_sdp_loss, port,
            lambda p: sdp_state_dict_from_flax(p, cfg, nll=True), b)


S2S = (("lyric2note", "lyric_src", "note_in"),
       ("lyric2duration", "lyric_src", "dur_in"),
       ("note2duration", "note_src", "dur_in"))


def case_seq2seq():
    from music_generation_tpu_torch.models.melody import default_langs
    lyric, note, dur = default_langs()
    # 4 tokens (the family's 16 unroll the JAX GRU loops 3 x 17 times)
    b = t_seq._Seq2SeqBatcher(t_seq._toy_melody_pairs(n=8), (lyric, note, dur),
                              t_len=4).batch(BS)
    vocabs = {"lyric2note": (lyric, note), "lyric2duration": (lyric, dur),
              "note2duration": (note, dur)}
    jms, params, ports, cfgs = {}, {}, {}, {}
    for i, (name, s, ti) in enumerate(S2S):
        cfg = t_s2s.Seq2SeqConfig(en_vocab=vocabs[name][0].n_items,
                                  de_vocab=vocabs[name][1].n_items,
                                  en_embedding_dim=32, de_embedding_dim=32,
                                  hidden_dim=32)
        jms[name] = j_s2s.Seq2SeqModel(same_config(j_s2s.Seq2SeqConfig, cfg))
        params[name] = init_params(jms[name], 5 + i, jnp.asarray(b[s]),
                                   jnp.asarray(b[ti]))
        ports[name], cfgs[name] = t_s2s.Seq2SeqModel(cfg), cfg
    port = torch.nn.ModuleDict(ports)

    def mapper(p):
        return {f"{n}.{k}": v for n in ports for k, v in
                seq2seq_state_dict_from_flax(p[n], cfgs[n]).items()}
    return (jl.seq2seq_family_loss, jms, params, tl.seq2seq_family_loss,
            port, mapper, b)


def case_telemelody():
    from music_generation_tpu_torch.models.melody.telemelody import \
        TeleMelodyGenerator
    b = _batch("telemelody")
    gen = TeleMelodyGenerator(t_tr.MelodyConfig(
        n_layers=1, d_model=32, d_ff=64, n_heads=2, dropout=0.0),
        device="cpu")
    jms, params, ports = {}, {}, {}
    for i, (name, cfg) in enumerate((("lyric2rhythm", gen.l2r_cfg),
                                     ("trend2melody", gen.t2m_cfg))):
        jms[name] = j_tr.MelodyTransformer(same_config(j_tr.MelodyConfig,
                                                       cfg))
        src, tgt = jnp.asarray(b[f"{name}_src"]), jnp.asarray(b[f"{name}_in"])
        params[name] = init_params(
            jms[name], 8 + i, src, tgt,
            (src != 0)[:, None, None, :].astype(jnp.int32),
            j_tr.causal_mask(tgt.shape[1]))
        ports[name] = t_tr.MelodyTransformer(cfg)
    port = torch.nn.ModuleDict(ports)

    def mapper(p):
        return {f"{n}.{k}": v for n in ports for k, v in state_dict_from_flax(
            p[n], ports[n], melody_rename).items()}
    return (jl.telemelody_family_loss, jms, params,
            tl.telemelody_family_loss, port, mapper, b)


def case_gpt2():
    from music_generation_tpu_torch.models.lyrics import default_tokenizer
    b = _batch("gpt2")
    cfg = t_gpt2.GPT2Config(vocab_size=default_tokenizer("gpt2", True)
                            .vocab_size, n_layer=1, n_embd=32, n_head=2,
                            n_positions=128)
    jm = j_gpt2.GPT2(same_config(j_gpt2.GPT2Config, cfg))
    params = init_params(jm, 10, jnp.zeros((1, 8), jnp.int32))
    return (jl.lm_loss, jm, params, tl.lm_loss, t_gpt2.GPT2(cfg),
            lambda p: gpt2_state_dict_from_flax(p, cfg), b)


def case_t5():
    from music_generation_tpu.models.lyrics import \
        default_tokenizer as j_default_tokenizer
    b = _batch("t5")
    jcfg = j_t5_config_for(j_default_tokenizer("t5", tiny=True), d_model=32,
                           d_kv=8, d_ff=64, num_layers=1,
                           num_decoder_layers=1, num_heads=4)
    cfg = same_config(t_t5.T5Config, jcfg)
    jm = j_t5.T5(jcfg)
    params = init_params(jm, 11, jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32),
                         jnp.zeros((1, 4), jnp.int32))
    return (jl.t5_loss, jm, params, tl.t5_loss, t_t5.T5(cfg),
            lambda p: t5_state_dict_from_flax(p, cfg), b)


CASES = {"melody_note": case_melody_note,
         "melody_note_prev": case_melody_note_prev,
         "seq2seq": case_seq2seq, "telemelody": case_telemelody,
         "duration_mse": case_duration_mse,
         "duration_sdp": case_duration_sdp,
         "gpt2": case_gpt2, "t5": case_t5}


@functools.lru_cache(maxsize=None)
def jax_run(family):
    """The case, and JAX's (loss, gradients, per-item output) in one
    jitted program: the per-item output is the SDP's NLL [B] (its own
    test reads it), else None."""
    case = CASES[family]()
    j_loss, jm, params, _, _, _, b = case
    jbatch = {k: jnp.asarray(v) for k, v in b.items() if k != "e_q"}
    rngs = {"dropout": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}

    def fn(p, bt):
        loss = j_loss(jm, p, bt, jax.random.PRNGKey(0))
        items = (jm.apply(p, bt["src"], bt["durations_cs"], rngs=rngs)
                 if family == "duration_sdp" else None)
        return loss, items
    with _no_dropout(), _jax_normal(b.get("e_q", np.zeros((BS, 1, 2)))):
        (want, items), jgrads = run_jax(jax.value_and_grad(fn, has_aux=True),
                                        params, jbatch)
    return case, want, jgrads, items


@pytest.mark.parametrize("family", list(CASES))
def test_family_loss_and_grads_match_jax(family):
    case, want, jgrads, _ = jax_run(family)
    j_loss, jm, params, t_loss, port, mapper, b = case
    port.load_state_dict(mapper(params))
    got = t_loss(port, {k: t(v) for k, v in b.items()},
                 torch.Generator().manual_seed(0))
    assert rel_err(got.detach().numpy(), np.asarray(want)) < LOSS_TOL, \
        (family, float(got), float(want))
    names, leaves = zip(*port.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(got, leaves,
                                                allow_unused=True)))
    want_grads = mapper(jax.tree_util.tree_map(np.asarray, jgrads))
    # entries the flax tree has no leaf for (zero-filled by the converter)
    present = mapper(jax.tree_util.tree_map(np.ones_like, params))
    assert set(want_grads) == set(grads)
    scale = max(np.abs(w.numpy()).max() for w in want_grads.values())
    for name, g in grads.items():
        w = want_grads[name].numpy()
        keep = present[name].numpy() != 0
        g = np.zeros_like(w) if g is None else g.numpy()
        err = np.abs(g - w)[keep].max(initial=0.0)
        if name.endswith(".k.bias"):
            # zero in exact arithmetic (softmax ignores a shift shared by
            # every key): both sides hold rounding noise only
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * scale
            continue
        assert err <= GRAD_TOL * np.abs(w[keep]).max(initial=0.0), \
            (family, name, err, np.abs(w).max())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5, 11).astype(np.float32) * 3
    targets = rng.randint(0, 11, (3, 5)).astype(np.int32)
    targets[0, 3:] = 0  # padding is masked out
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                            label_smoothing=smoothing)
    got = tl.cross_entropy(t(logits), t(targets), label_smoothing=smoothing)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-6
    # an all-pad batch divides by 1, not 0
    assert float(tl.cross_entropy(t(logits), t(np.zeros_like(targets)))) == 0


def test_sdp_nll_matches_jax_on_same_e_q():
    """SDPDurationModel.forward (the NLL per item over sum(mask)) against
    the JAX __call__ with the posterior noise fed to both; the
    inference-only mapping drops flow 0 and the posterior, the NLL
    mapping carries every leaf."""
    case, _, _, want = jax_run("duration_sdp")
    _, _, params, _, _, mapper, b = case
    port = zero_dropout(t_tr.SDPDurationModel(case[4].cfg, nll=True))
    port.load_state_dict(mapper(params))
    got = port(t(b["src"]), t(b["durations_cs"]), e_q=t(b["e_q"]))
    assert got.shape == (BS,)
    assert rel_err(got.detach().numpy(), np.asarray(want)) < LOSS_TOL
    served = t_tr.SDPDurationModel(port.cfg)
    served.load_state_dict(sdp_state_dict_from_flax(params, port.cfg))
    assert len(served.state_dict()) < len(port.state_dict())


@pytest.mark.parametrize("prev_active", [None, 1, 0])
def test_concat_prev_memory_matches_jax(prev_active):
    """prev_mode="concat": memory [B, S + P, D] is the encoder rows then
    the previous note embeddings; the mask appends the non-pad prev ids,
    gated by prev_active (None: always on)."""
    j_loss, jm, params, _, port, mapper, b = case_melody_note_prev()
    port.load_state_dict(mapper(params))
    src, prev = b["src"], b["prev"]
    attn = (src != 0)[:, None, None, :].astype(np.int32)
    kw = {} if prev_active is None else {"prev_active": prev_active}
    want_mem, want_mask = jm.apply(params, jnp.asarray(src),
                                   jnp.asarray(attn), jnp.asarray(prev),
                                   method=j_tr.MelodyTransformer.prev_memory,
                                   **kw)
    mem, mask = port.prev_memory(t(src), t(attn), t(prev),
                                 True if prev_active is None else prev_active)
    assert mem.shape == (BS, src.shape[1] + prev.shape[1], 32)
    assert rel_err(mem.detach().numpy(), np.asarray(want_mem)) < 1e-5
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask[:, 0, 0, src.shape[1]:].sum() == \
        (0 if prev_active == 0 else (prev != 0).sum())


def test_dropout_keep_rate_scaling_and_generator():
    x = torch.ones(200_000)
    a = dropout(x, 0.3, False, torch.Generator().manual_seed(5))
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert torch.equal(a, dropout(x, 0.3, False,
                                  torch.Generator().manual_seed(5)))
    assert not torch.equal(a, dropout(x, 0.3, False,
                                      torch.Generator().manual_seed(6)))
    assert dropout(x, 0.3, True) is x and dropout(x, 0.0, False) is x
    # through a model: the same generator seed gives the same loss, and
    # deterministic=True none of the masks
    model, loss_fn, batcher = t_seq.build_family("melody_note", True, None,
                                                 0, "cpu")
    bt = {k: t(v) for k, v in batcher.batch(BS).items()}
    losses = [float(loss_fn(model, bt, torch.Generator().manual_seed(s))
                    .detach()) for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


def test_optimizer_matches_optax_over_three_steps():
    """SeqOptimizer against optax.chain(clip_by_global_norm(5.0),
    adamw(lr)); the second step's gradients are large enough to clip."""
    rng = np.random.RandomState(0)
    params = [rng.randn(4, 3).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params]
             for s in (0.5, 20.0, 1.0)]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(3e-3))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt = tl.SeqOptimizer(tp, 3e-3)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([t(x) for x in g])
        for a, b in zip(tp, jp):
            assert rel_err(a.detach().numpy(), np.asarray(b)) < 1e-6
