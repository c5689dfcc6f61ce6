"""The port's GAN training step vs the JAX package (CPU, tiny config).

build_svs_config(tiny=True), batch 2, 8 phones, 32 frames from the JAX
package's synthetic_batch, numpy-seeded unit-scale generator weights and
the full-width MultiPeriodDiscriminator, carried across with compat.
The JAX side runs with its draws replaced by the port's: jax.random.normal
(posterior, then reverse-KL noise) and jax.random.uniform (slice starts)
are patched while the reference traces. One jitted JAX gradient of the
generator loss, one of the discriminator loss and one MAS forward are
shared by the tests (module-scoped fixture).

Tolerances: VISinger.forward outputs, the discriminators' scores and
feature maps and the loss terms within 1e-4 relative L2, MAS duration
targets identical, gradients within 1e-3
relative L2 per parameter tensor, the optimizer within 1e-6.
"""

import contextlib
import json
import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_generation_tpu.audio.stft import mel_spectrogram as j_mel
from music_generation_tpu.core.masking import slice_segments as j_slice
from music_generation_tpu.models.svs import hifigan as jh
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu.train import configs as j_configs
from music_generation_tpu.train import data as j_data
from music_generation_tpu.train import losses as jl
from music_generation_tpu.train import trainer as j_trainer
from music_generation_tpu_torch.compat import (mpd_state_dict_from_flax,
                                               visinger_state_dict_from_flax)
from music_generation_tpu_torch.models.svs import hifigan as th
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.ops import maximum_path
from music_generation_tpu_torch.train import (TrainConfig, build_svs_config,
                                              create_states, make_train_step,
                                              restore_checkpoint,
                                              save_checkpoint,
                                              synthetic_batch, trainer)
from music_generation_tpu_torch.train.__main__ import main as train_main
from torch_port_util import init_params, rel_err, t

FWD_TOL = 1e-4
GRAD_TOL = 1e-3
OPT_TOL = 1e-6
B, PHONES, FRAMES = 2, 8, 32
CFG = build_svs_config(tiny=True)
JCFG = j_configs.build_svs_config(tiny=True)
SEG = CFG.segment_size
FWD_KEYS = ("audio", "duration_fraction", "z", "z_p", "m_p", "logs_p", "m_q",
            "logs_q", "log_f0", "mel_predict", "spec_predict", "z_hat")
LOSS_KEYS = ("loss_mel", "loss_kl", "loss_kl_rev", "loss_dur", "loss_f0",
             "loss_adv", "loss_fm", "loss_dc", "loss_energy", "loss_spec",
             "loss_gen", "audio_dc")


def _batch():
    return j_data.synthetic_batch(JCFG, batch=B, t_phones=PHONES,
                                  t_frames=FRAMES, seed=0)


def _draws(seed=3):
    rng = np.random.RandomState(seed)
    shape = (B, FRAMES, CFG.inter_channels)
    return {"noise": rng.randn(*shape).astype(np.float32),
            "noise_rev": rng.randn(*shape).astype(np.float32),
            "slice_u": rng.uniform(0, 1, (B,)).astype(np.float32)}


@contextlib.contextmanager
def jax_draws(draws):
    """While the JAX reference traces, jax.random.normal gives the
    posterior noise, then the reverse-KL noise, and jax.random.uniform the
    slice-start uniforms."""
    normals = [draws["noise"], draws["noise_rev"]]
    calls = []

    def normal(key, shape, dtype=jnp.float32):
        out = normals[len(calls) % 2]
        calls.append(shape)
        assert tuple(shape) == out.shape
        return jnp.asarray(out, dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert tuple(shape) == draws["slice_u"].shape
        return jnp.asarray(draws["slice_u"], dtype)

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform):
        yield


def _gen_args(batch):
    return (batch["phones"], batch["x_lengths"], batch["spec"],
            batch["y_lengths"], batch["note_ids"], batch["note_durations"],
            batch["f0_score"], batch["phone_durations"], batch["shengdiao"])


def _jax_gen_loss(jm, jd):
    """The JAX trainer's gen_loss_fn composition of losses.*, with the
    forward deterministic (gen_loss_fn always runs with dropout on)."""
    tc = j_trainer.TrainConfig()
    rngs = {"noise": jax.random.PRNGKey(0), "slice": jax.random.PRNGKey(1)}

    def loss(gp, dp, batch):
        out = jm.apply({"params": gp}, *_gen_args(batch), deterministic=True,
                       rngs=rngs)
        y_real = j_slice(batch["audio"], out["ids_slice"] * JCFG.hop_length,
                         SEG)
        _, d_fake, fmap_r, fmap_g = jd.apply({"params": dp}, y_real,
                                             out["audio"])
        audio = out["audio"][..., 0]
        m = {"loss_mel": jl.l1_masked(
            j_mel(audio, JCFG.sampling_rate, hop=JCFG.hop_length),
            j_mel(y_real[..., 0], JCFG.sampling_rate,
                  hop=JCFG.hop_length)) * tc.c_mel}
        m["loss_kl"] = jl.kl_divergence(out["z_p"], out["logs_q"], out["m_p"],
                                        out["logs_p"], out["y_mask"]) * tc.c_kl
        m["loss_kl_rev"] = jl.gaussian_nll(
            out["z_hat"], jax.lax.stop_gradient(out["m_q"]),
            jax.lax.stop_gradient(out["logs_q"]), out["y_mask"]) * tc.c_kl_rev
        m["loss_dur"] = jl.duration_loss(
            out["duration_fraction"], batch["note_durations"],
            out["duration_targets"], JCFG.frame_seconds,
            out["x_mask"][..., 0])
        m["loss_f0"] = jl.f0_loss(out["log_f0"], batch["log_f0"],
                                  out["y_mask"][..., 0])
        m["loss_adv"] = jl.generator_adv_loss(d_fake) * tc.c_adv
        m["loss_fm"] = jl.feature_matching_loss(fmap_r, fmap_g) * tc.c_fm
        m["loss_dc"] = jnp.mean(jnp.mean(audio, axis=1) ** 2) * tc.c_dc
        m["loss_energy"] = jl.energy_loss(audio, y_real[..., 0]) \
            * tc.c_energy
        total = sum(m.values())
        m["loss_spec"] = jl.l1_masked(out["spec_predict"], batch["spec"],
                                      out["y_mask"]) * tc.c_mel
        m["loss_gen"] = total + m["loss_spec"]
        m["audio_dc"] = jnp.mean(out["audio"])
        return m["loss_gen"], (m, out)

    return loss


def _jax_disc_loss(jd):
    def loss(dp, y_real, y_fake):
        d_real, d_fake, _, _ = jd.apply({"params": dp}, y_real,
                                        jax.lax.stop_gradient(y_fake))
        return jl.discriminator_adv_loss(d_real, d_fake)
    return loss


@pytest.fixture(scope="module")
def ref():
    """Weights, batch and draws, and the JAX reference computed once."""
    batch, draws = _batch(), _draws()
    jm, jd = jv.VISinger(JCFG), jh.MultiPeriodDiscriminator()
    gp = init_params(jm, 0, *_gen_args(batch), deterministic=True)["params"]
    seg = np.zeros((1, SEG, 1), np.float32)
    dp = init_params(jd, 1, seg, seg)["params"]
    with jax_draws(draws):
        (_, (metrics, out)), g_grads = jax.jit(jax.value_and_grad(
            _jax_gen_loss(jm, jd), has_aux=True))(gp, dp, batch)
        mas_out = jax.jit(lambda p, b: jm.apply(
            {"params": p}, *_gen_args(b), deterministic=True, use_mas=True,
            rngs={"noise": jax.random.PRNGKey(0),
                  "slice": jax.random.PRNGKey(1)}))(gp, batch)
    y_real = np.asarray(j_slice(batch["audio"],
                                out["ids_slice"] * JCFG.hop_length, SEG))
    y_fake = np.asarray(out["audio"])
    d_loss, d_grads = jax.jit(jax.value_and_grad(_jax_disc_loss(jd)))(
        dp, y_real, y_fake)
    gen = tv.VISinger(CFG)
    gen.load_state_dict(visinger_state_dict_from_flax(gp, CFG))
    disc = th.MultiPeriodDiscriminator()
    disc.load_state_dict(mpd_state_dict_from_flax(dp))
    return {"batch": batch, "draws": draws, "gen": gen, "disc": disc,
            "disc_params": dp,
            "metrics": metrics, "out": out, "g_grads": g_grads,
            "mas_out": mas_out, "y_real": y_real, "y_fake": y_fake,
            "d_loss": d_loss, "d_grads": d_grads}


def _tensors(batch):
    return {k: t(v) for k, v in batch.items()}


def _port_forward(ref, use_mas=False):
    tc = TrainConfig(use_mas=use_mas)
    return trainer.gen_forward(ref["gen"], _tensors(ref["batch"]), tc,
                               deterministic=True,
                               **{k: t(v) for k, v in ref["draws"].items()})


def _assert_grads(port_grads: dict, want: dict, tol: float):
    """Each tensor within ``tol`` relative L2 of the reference. The
    attention key biases have an exact gradient of zero (they shift all of
    a query's scores alike, which the softmax ignores), so both sides hold
    float32 rounding there: held within 1e-6 of the largest gradient's
    norm instead."""
    assert port_grads.keys() == want.keys()
    scale = max(np.linalg.norm(w.numpy()) for w in want.values())
    for name, g in port_grads.items():
        w = want[name].numpy()
        if name.endswith(".k.bias"):
            assert np.linalg.norm(g.numpy() - w) <= 1e-6 * scale, name
            continue
        assert np.linalg.norm(w) > 0, name
        err = rel_err(g, w)
        assert err <= tol, (name, err)


def test_synthetic_batch_matches_jax():
    want = _batch()
    got = synthetic_batch(CFG, batch=B, t_phones=PHONES, t_frames=FRAMES,
                          seed=0)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k == "spec":  # two FFT implementations
            assert rel_err(got[k], want[k]) <= 1e-5
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("use_mas", [False, True])
def test_forward_matches_jax(ref, use_mas):
    want = ref["mas_out"] if use_mas else ref["out"]
    with torch.no_grad():
        got = _port_forward(ref, use_mas)
    assert got.keys() == want.keys()
    # the durations that drove the length regulator: identical
    np.testing.assert_array_equal(got["duration_targets"].numpy(),
                                  np.asarray(want["duration_targets"]))
    np.testing.assert_array_equal(got["ids_slice"].numpy(),
                                  np.asarray(want["ids_slice"]))
    for k in ("x_mask", "y_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in FWD_KEYS:
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= FWD_TOL, k
    if use_mas:
        d = got["duration_targets"].numpy()
        np.testing.assert_array_equal(d.sum(1), ref["batch"]["y_lengths"])
        assert not np.array_equal(d, ref["batch"]["phone_durations"])


def test_generator_loss_and_grads_match_jax(ref):
    gen, disc = ref["gen"], ref["disc"]
    out = _port_forward(ref)
    total, metrics = trainer.generator_loss(
        disc, out, _tensors(ref["batch"]), CFG, TrainConfig())
    for k in LOSS_KEYS:
        assert rel_err(metrics[k], ref["metrics"][k]) <= FWD_TOL, k
    names = [n for n, _ in gen.named_parameters()]
    grads = torch.autograd.grad(total, list(gen.parameters()))
    want = visinger_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, ref["g_grads"]), CFG)
    _assert_grads(dict(zip(names, grads)), want, GRAD_TOL)


def test_discriminator_loss_and_grads_match_jax(ref):
    disc = ref["disc"]
    d_real, d_fake, _, _ = disc(t(ref["y_real"]), t(ref["y_fake"]))
    from music_generation_tpu_torch.train import losses
    d_loss = losses.discriminator_adv_loss(d_real, d_fake)
    assert rel_err(d_loss.detach(), ref["d_loss"]) <= FWD_TOL
    names = [n for n, _ in disc.named_parameters()]
    grads = torch.autograd.grad(d_loss, list(disc.parameters()))
    want = mpd_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, ref["d_grads"]))
    _assert_grads(dict(zip(names, grads)), want, GRAD_TOL)


@pytest.mark.parametrize("name", ["disc_s", "disc_p3"])
def test_discriminator_matches_flax(ref, name):
    """DiscriminatorS and DiscriminatorP(3) (128 % 3 != 0: the reflect pad
    runs) on a 128-sample segment, weights carried by
    mpd_state_dict_from_flax: the scores and every feature map within
    1e-4. The port's NCHW / NCW maps are put in flax's NHWC / NWC layout."""
    x = np.random.RandomState(4).uniform(-1, 1, (B, 128, 1)).astype(
        np.float32)
    jd = jh.DiscriminatorS() if name == "disc_s" else \
        jh.DiscriminatorP(int(name[len("disc_p"):]))
    want_out, want_fmap = jd.apply({"params": ref["disc_params"][name]}, x)
    with torch.no_grad():
        got_out, got_fmap = getattr(ref["disc"], name)(t(x))
    assert got_out.shape == want_out.shape
    assert rel_err(got_out, want_out) <= FWD_TOL
    n_maps = 7 if name == "disc_s" else 6   # each conv, then conv_post
    assert len(got_fmap) == len(want_fmap) == n_maps
    for i, (g, w) in enumerate(zip(got_fmap, want_fmap)):
        g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g.transpose(1, 2)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert rel_err(g, w) <= FWD_TOL, i


OPT_CASES = {
    "warmup": dict(warmup_steps=3),
    "decay_2_step_epoch": dict(steps_per_epoch=2, lr_decay=0.5),
    "both_clips": dict(grad_clip_norm=1.0, grad_clip=0.02),
    "accumulate_2": dict(accumulate_grad_batches=2, steps_per_epoch=4,
                         lr_decay=0.7, warmup_steps=1),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(OPT_CASES[case], learning_rate=0.05)
    rng = np.random.RandomState(len(case))
    params = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2,))]
    grads = [[(rng.randn(*p.shape) * 3).astype(np.float32) for p in params]
             for _ in range(6)]
    if case == "both_clips":
        norm = np.sqrt(sum((g ** 2).sum() for g in grads[0]))
        assert norm > kw["grad_clip_norm"]
        assert np.abs(grads[0][0]).max() * kw["grad_clip_norm"] / norm \
            > kw["grad_clip"]
    tx = j_trainer.make_optimizer(j_trainer.TrainConfig(**kw))
    j_params = [jnp.asarray(p) for p in params]
    state = tx.init(j_params)
    port_params = [torch.tensor(p) for p in params]
    opt = trainer.Optimizer(port_params, TrainConfig(**kw))
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                   j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.tensor(x) for x in g])
        for got, want in zip(port_params, j_params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=OPT_TOL)
    assert not np.allclose(port_params[0].numpy(), params[0])


# ---- port-only behaviour, as tests/test_train.py checks the JAX trainer --

def _states(**kw):
    tc = TrainConfig(**kw)
    gen_state, disc_state = create_states(CFG, tc, "cpu")
    batch = _tensors(synthetic_batch(CFG, batch=B, t_phones=PHONES,
                                     t_frames=FRAMES, seed=1))
    return tc, gen_state, disc_state, batch


def _snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def _moved(before, module) -> bool:
    return any(not torch.equal(a, b) for a, b in
               zip(before, module.parameters()))


@pytest.mark.parametrize("kw", [dict(disc_loss_floor=1e9), dict(c_adv=0.0)],
                         ids=["disc_loss_floor", "c_adv_0"])
def test_discriminator_frozen_or_skipped(kw):
    tc, gen_state, disc_state, batch = _states(**kw)
    g0, d0 = _snapshot(gen_state.model), _snapshot(disc_state.model)
    metrics = make_train_step(CFG, tc)(gen_state, disc_state, batch,
                                       torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert _moved(g0, gen_state.model) and gen_state.step == 1
    assert not _moved(d0, disc_state.model)
    assert disc_state.step == 0 and disc_state.opt.count == 0
    assert (float(metrics["loss_disc"]) == 0.0) == (tc.c_adv == 0.0)


def test_train_step_updates_both_and_dropout_is_seeded():
    tc, gen_state, disc_state, batch = _states()
    step = make_train_step(CFG, tc)
    g0, d0 = _snapshot(gen_state.model), _snapshot(disc_state.model)
    metrics = step(gen_state, disc_state, batch,
                   torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert _moved(g0, gen_state.model) and _moved(d0, disc_state.model)
    assert gen_state.step == disc_state.step == 1

    # dropout: applied with deterministic=False, reproducible from a seed
    gen = gen_state.model

    def forward(deterministic, seed):
        with torch.no_grad():
            return trainer.gen_forward(
                gen, batch, tc, deterministic=deterministic,
                generator=torch.Generator().manual_seed(seed))["mel_predict"]
    a, b, c, d = forward(False, 5), forward(False, 5), forward(False, 6), \
        forward(True, 5)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


@contextlib.contextmanager
def mas_inputs():
    """Records the dtypes of what ops.maximum_path passes, unchanged, to
    its plain version on the CPU (which still runs)."""
    from music_generation_tpu_torch.ops import monotonic_align as t_ma
    seen, plain = [], t_ma.maximum_path_torch

    def spy(neg_cent, mask):
        seen.append((neg_cent.dtype, mask.dtype))
        return plain(neg_cent, mask)
    with mock.patch.object(t_ma, "maximum_path_torch", spy):
        yield seen


def test_bf16_train_step_finite_and_close_to_f32():
    """--bf16 (TrainConfig.bf16_run) as tests/test_train.py holds the JAX
    trainer, here with MAS durations: from the same weights, batch and
    generator seed every metric is finite and within 20 % of the float32
    step's, the masters stay float32 and both networks moved, and MAS got
    float32 inputs in both generator forwards."""
    batch = _tensors(synthetic_batch(CFG, batch=B, t_phones=PHONES,
                                     t_frames=FRAMES, seed=1))
    metrics, states = {}, {}
    for bf16 in (False, True):
        tc = TrainConfig(use_mas=True, bf16_run=bf16)
        gen_state, disc_state = create_states(CFG, tc, "cpu")
        g0, d0 = _snapshot(gen_state.model), _snapshot(disc_state.model)
        with mas_inputs() as seen:
            metrics[bf16] = make_train_step(CFG, tc)(
                gen_state, disc_state, batch,
                torch.Generator().manual_seed(0))
        states[bf16] = (gen_state, disc_state, g0, d0, seen)
    for k, v in metrics[True].items():
        got, want = float(v), float(metrics[False][k])
        assert np.isfinite(got), k
        assert abs(got - want) / (abs(want) + 1e-3) < 0.2, (k, want, got)
    gen_state, disc_state, g0, d0, seen = states[True]
    for module, before in ((gen_state.model, g0), (disc_state.model, d0)):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert _moved(before, module)
    assert seen == [(torch.float32, torch.float32)] * 2
    # bf16 really ran: the two steps differ
    assert any(float(metrics[True][k]) != float(metrics[False][k])
               for k in metrics[True])


def test_mas_casts_bf16_neg_cent_to_float32():
    """A bfloat16 alignment score (mas_neg_cent on bfloat16 inputs) reaches
    maximum_path as float32, and the durations are the plain version's on
    that cast."""
    from music_generation_tpu_torch.ops.monotonic_align import (
        mas_duration_targets, mas_neg_cent, maximum_path_torch)
    rng = np.random.RandomState(2)
    z_p, m_p, logs_p = (t(rng.randn(B, n, 4).astype(np.float32))
                        .to(torch.bfloat16) for n in (FRAMES, PHONES, PHONES))
    x_mask = torch.ones(B, PHONES, 1, dtype=torch.bfloat16)
    y_mask = torch.ones(B, FRAMES, 1, dtype=torch.bfloat16)
    neg_cent, attn = mas_neg_cent(z_p, m_p, logs_p, x_mask, y_mask)
    assert neg_cent.dtype == torch.bfloat16
    with mas_inputs() as seen:
        got = mas_duration_targets(z_p, m_p, logs_p, x_mask, y_mask)
    assert seen == [(torch.float32, torch.float32)]
    want = maximum_path_torch(neg_cent.float(), attn.float()).sum(dim=1)
    assert torch.equal(got, want.to(torch.int32))
    assert int(got.sum()) == B * FRAMES


def test_cli_trains_bf16_with_mas_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    ck = str(tmp_path / "ck")
    plain = maximum_path.plain_calls
    train_main(["--tiny", "--device", "cpu", "--bf16", "--durations", "mas",
                "--ckpt-dir", ck, "--steps", "1", "--batch-size", "2",
                "--warmup-steps", "0"])
    assert maximum_path.plain_calls == plain + 2
    saved = torch.load(os.path.join(ck, "step_1.pt"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved["gen"].values()
               if v.is_floating_point())
    with open(os.path.join(ck, "logs", "train_metrics.jsonl")) as fh:
        row = json.loads(fh.readline())
    assert np.isfinite(row["loss_gen"]) and row["loss_disc"] > 0
    shutil.rmtree(ck)  # the full discriminator's step file, some 0.55 GB


def test_checkpoint_round_trip_and_pruning(tmp_path):
    """A half-accumulated optimizer (one of two mini-steps taken) saved
    four times: the newest two and the best are kept, and a restore gives
    the same weights and optimizer state. (A small stand-in discriminator
    keeps the files small; the CLI test resumes the real one.)"""
    tc = TrainConfig(accumulate_grad_batches=2)

    def states(seed):
        torch.manual_seed(seed)
        gen, disc = tv.VISinger(CFG), torch.nn.Conv1d(1, 4, 3)
        return (trainer.TrainState(gen, trainer.Optimizer(gen.parameters(),
                                                          tc)),
                trainer.TrainState(disc, trainer.Optimizer(
                    disc.parameters(), tc)))
    gen_state, disc_state = states(0)
    for state in (gen_state, disc_state):
        state.apply_gradients([torch.randn_like(p)
                               for p in state.model.parameters()])
    path = str(tmp_path / "ck")
    for i, mel in enumerate([3.0, 1.0, 2.0, 4.0], start=1):
        save_checkpoint(path, gen_state, disc_state, i, keep_last=2,
                        metric=mel)
    assert sorted(os.listdir(path)) == ["best.json", "step_2.pt",
                                        "step_3.pt", "step_4.pt"]
    with open(os.path.join(path, "best.json")) as fh:
        assert json.load(fh)["step"] == 2
    g2, d2 = states(1)
    restore_checkpoint(os.path.join(path, "step_4.pt"), g2, d2)
    assert g2.step == d2.step == 1
    assert g2.opt.mini_step == 1 and g2.opt.count == 0
    for a, b in zip(gen_state.model.state_dict().values(),
                    g2.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(gen_state.opt.acc + disc_state.opt.acc,
                    g2.opt.acc + d2.opt.acc):
        assert torch.equal(a, b) and a.abs().sum() > 0


def test_cli_trains_with_mas_on_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    plain, launches = maximum_path.plain_calls, maximum_path.kernel_launches
    args = ["--tiny", "--device", "cpu", "--durations", "mas", "--ckpt-dir",
            ck, "--log-every", "1", "--warmup-steps", "0", "--batch-size",
            "2"]
    train_main(args + ["--steps", "2"])
    # MAS in both generator forwards of each step, on the plain version
    assert maximum_path.plain_calls == plain + 4
    assert maximum_path.kernel_launches == launches
    assert sorted(os.listdir(ck)) == ["best.json", "logs", "step_2.pt"]
    train_main(args + ["--steps", "1", "--resume",
                       os.path.join(ck, "step_2.pt")])
    assert "step_3.pt" in os.listdir(ck)
    with open(os.path.join(ck, "logs", "train_metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["loss_gen"]) and r["loss_disc"] > 0
               for r in rows)
    shutil.rmtree(ck)  # two step files of the full discriminator, 1.1 GB


@pytest.mark.parametrize("flag", [
    ["--proc-id", "1"], ["--nprocs", "2"], ["--proc-id", "0"],
    ["--multihost"], ["--n-model", "2"], ["--multihost", "--packed", "x"],
    ["--coordinator", "x"]])
def test_cli_refuses_unported_flags(flag, capsys, monkeypatch):
    """The multi-device flags are ported (tests/test_torch_multihost.py);
    a combination that cannot run exits 2 naming its flag before a corpus
    is read or a process group is joined: a process flag or --n-model > 1
    without --multihost (one process drives one device), and --multihost
    with neither --coordinator nor torchrun's environment."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        train_main(["--tiny", "--device", "cpu", "--steps", "1"] + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err
    assert "needs --multihost" in err or "torchrun's environment" in err


def test_server_refuses_mesh(capsys):
    """serve.app takes --mesh (tests/test_torch_mesh.py) and refuses a
    mesh larger than the devices, naming the count, before any model is
    built."""
    from music_generation_tpu_torch.serve import app as t_app
    with pytest.raises(SystemExit) as e:
        t_app.configure(["--tiny", "--device", "cpu", "--mesh", "4x2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--mesh" in err and "needs 8 devices; 1 available" in err


def test_cli_refuses_missing_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--tiny", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_create_states_refuses_missing_gpu():
    """With no device given, create_states builds on cuda, as the other
    entry points do; without a GPU it raises instead of training on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_states(CFG, TrainConfig())
