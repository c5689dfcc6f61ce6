"""The SVS F0 and excitation variants and the bf16 decoder of the PyTorch
port vs the JAX package (CPU, tiny configs).

NSF harmonic excitation (models/svs/excitation.py and the HiFi-GAN
generator's exc convs), f0_mode="score", the residual F0 head and
decoder_bf16: each held against its JAX twin on the same numpy-seeded
unit-scale weights (carried by compat.visinger_state_dict_from_flax) and
the same injected noise and draws. The JAX side runs op by op (no jit):
after the first call its compiled primitives are reused, which is cheaper
here than tracing and compiling each configuration's program.

Tolerances:
  - the phase (cycles, the cumsum before the sine): port and JAX each
    within PHASE_TOL_ULPS float32 ulps of the phase's magnitude of a
    float64 reference; the excitation within the same bound times 2 pi
    times its amplitude (absolute); unvoiced samples exactly zero
  - note_hz_frames: the same frames at 0 Hz (rests, past the end), the
    rest within HZ_REL_TOL relative (XLA's float32 exp2 and torch's differ
    by up to 2 ulps; against the exact float64 value torch errs by at most
    1.2 ulps and XLA by 2.3)
  - the Generator with exc, VISinger.infer, VISinger.forward outputs and
    loss terms: 1e-4 relative L2; log_f0_used within 1e-6 absolute
  - the generator's parameter gradients: 1e-3 relative L2 per tensor (the
    attention key biases, whose exact gradient is zero, within 1e-6 of the
    largest gradient's norm)
  - decoder_bf16: relative mean absolute error below 0.15 (the bound of
    tests/test_bf16_decoder.py), port bf16 against JAX bf16 and against
    port float32
"""

import base64
import dataclasses
import io
import json
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.audio.stft import mel_spectrogram as j_mel
from music_generation_tpu.core import layers as j_layers
from music_generation_tpu.core.masking import slice_segments as j_slice
from music_generation_tpu.models.svs import excitation as je
from music_generation_tpu.models.svs import hifigan as jh
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu.train import configs as j_configs
from music_generation_tpu.train import data as j_data
from music_generation_tpu.train import losses as jl
from music_generation_tpu_torch.compat import (state_dict_from_flax,
                                               visinger_state_dict_from_flax,
                                               visinger_state_dict_from_torch)
from music_generation_tpu_torch.audio.stft import mel_spectrogram as t_mel
from music_generation_tpu_torch.core.masking import slice_segments
from music_generation_tpu_torch.models.svs import excitation as te
from music_generation_tpu_torch.models.svs import hifigan as th
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.ops import maximum_path
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.train import build_svs_config
from music_generation_tpu_torch.train import losses as tl
from music_generation_tpu_torch.train.__main__ import main as train_main
from test_istft_decoder import TINY, TINY_ISTFT, TINY_MB
from test_torch_istft import _jax_decoder
from test_torch_train import _assert_grads, _gen_args, jax_draws
from torch_port_util import init_params, rel_err, t

FWD_TOL = 1e-4
GRAD_TOL = 1e-3
LF0_TOL = 1e-6
HZ_REL_TOL = 3e-7
BF16_REL_MAE = 0.15
PHASE_TOL_ULPS = 64
SR = 22050


def _phase_f64(log_f0: np.ndarray, hop: int) -> np.ndarray:
    """The phase in cycles in float64 from the float32 log-F0."""
    lf = log_f0.astype(np.float64)
    f0 = np.expm1(np.clip(lf, 0.0, 9.0)) * (log_f0 > je.VOICED_LOG_F0_MIN)
    return np.cumsum(np.repeat(f0, hop, axis=1) / SR, axis=1)


def _phase_tol(phase64: np.ndarray) -> float:
    """PHASE_TOL_ULPS float32 ulps at the phase's largest magnitude."""
    return PHASE_TOL_ULPS * float(np.spacing(np.float32(
        max(np.abs(phase64).max(), 1.0))))


def _log_f0(case: str) -> tuple[np.ndarray, int]:
    """(log1p-F0 [B, T] float32, hop) of an excitation case."""
    hz = np.log1p
    if case == "tone":        # 64 frames of middle C at the served hop
        return np.full((1, 64), hz(261.63), np.float32), 256
    if case == "gaps":        # unvoiced gaps: below the threshold, at 0
        row = np.full(40, hz(200.0))
        row[8:12] = 0.0
        row[20:23] = je.VOICED_LOG_F0_MIN - 0.01
        return np.stack([row, row[::-1]]).astype(np.float32), 16
    # a note, a rest, then another note
    row = np.concatenate([np.full(10, hz(330.0)), np.zeros(5),
                          np.full(10, hz(523.25))])
    return row[None].astype(np.float32), 64


@pytest.mark.parametrize("case", ["tone", "gaps", "rest_restart"])
def test_harmonic_excitation_matches_jax(case):
    log_f0, hop = _log_f0(case)
    want64 = _phase_f64(log_f0, hop)
    tol = _phase_tol(want64)
    cycles, voiced = te.harmonic_phase(t(log_f0), hop, SR)
    np.testing.assert_array_equal(voiced.numpy(),
                                  log_f0 > je.VOICED_LOG_F0_MIN)
    assert np.abs(cycles.numpy() - want64).max() <= tol
    want = np.asarray(je.harmonic_excitation(jnp.asarray(log_f0), hop,
                                             SR))
    got = te.harmonic_excitation(t(log_f0), hop, SR).numpy()
    assert got.shape == want.shape == (log_f0.shape[0],
                                       log_f0.shape[1] * hop, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.pi * je.EXC_AMPLITUDE * 2 * tol)
    unvoiced = np.repeat(log_f0 <= je.VOICED_LOG_F0_MIN, hop, axis=1)
    assert np.all(got[..., 0][unvoiced] == 0.0)
    assert np.abs(got).max() <= te.EXC_AMPLITUDE + 1e-6
    if case == "gaps":
        # the phase holds over a gap: splice it out and the source is the
        # continuous rendering of the voiced frames
        row = log_f0[:1]
        keep = row[0] > je.VOICED_LOG_F0_MIN
        cont = te.harmonic_excitation(t(row[:, keep]), hop, SR).numpy()
        spliced = got[:1][:, np.repeat(keep, hop)]
        np.testing.assert_allclose(spliced, cont, rtol=0, atol=1e-6)


def test_excitation_keeps_float32_for_bf16_input():
    log_f0, hop = _log_f0("rest_restart")
    lf = t(log_f0).to(torch.bfloat16)
    exc = te.harmonic_excitation(lf, hop, SR)
    assert exc.dtype == torch.float32
    np.testing.assert_array_equal(
        exc.numpy(), te.harmonic_excitation(lf.float(), hop, SR).numpy())


def test_note_hz_frames_matches_jax():
    rng = np.random.RandomState(3)
    notes = rng.randint(0, 100, (3, 12)).astype(np.int32)
    notes[:, ::4] = 0                                      # rests
    frames = rng.randint(0, 5, (3, 12)).astype(np.int32)
    want = np.asarray(jv.note_hz_frames(jnp.asarray(notes),
                                        jnp.asarray(frames), 40))
    got = tv.note_hz_frames(t(notes), t(frames), 40).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=HZ_REL_TOL, atol=0)


GEN_CONFIGS = {
    # the tiny trainer's generator (hop 16) and the tiny server's (hop 256)
    "train": dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8)),
    "serve": dict(upsample_rates=(8, 8, 2, 2),
                  upsample_kernel_sizes=(16, 16, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(GEN_CONFIGS))
def test_generator_with_excitation_matches_flax(name):
    kw = GEN_CONFIGS[name]
    rates = kw["upsample_rates"]
    hop = int(np.prod(rates))
    frames = 6
    rng = np.random.RandomState(5)
    hidden = rng.randn(2, frames, 16).astype(np.float32)
    log_f0 = np.log1p(rng.uniform(100, 500, (2, frames))).astype(np.float32)
    exc = np.asarray(je.harmonic_excitation(jnp.asarray(log_f0), hop, SR))
    common = dict(resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),),
                  upsample_initial_channel=32, **kw)
    jgen = jh.Generator(**common)
    params = init_params(jgen, 6, jnp.asarray(hidden), exc=jnp.asarray(exc))
    assert sorted(k for k in params["params"] if k.startswith("exc_")) == \
        [f"exc_{i}" for i in range(len(rates))]
    port = th.Generator(16, **common, nsf=True)
    port.load_state_dict(state_dict_from_flax(params, port))
    want = np.asarray(jgen.apply(params, hidden, exc=exc))
    with torch.no_grad():
        got = port(t(hidden), t(exc)).numpy()
    assert got.shape == want.shape == (2, frames * hop, 1)
    assert rel_err(got, want) <= FWD_TOL
    # each stage's injected source has exactly the stage's length, in the
    # port and in flax's conv (its padding and stride)
    rate = 1
    for i, (u, conv) in enumerate(zip(rates, port.exc)):
        rate *= u
        length = conv(t(exc).transpose(1, 2)).shape[-1]
        jconv = j_layers.Conv1d(conv.weight.shape[0], conv.weight.shape[-1],
                                stride=conv.stride)
        jshape = jax.eval_shape(lambda x: jconv.init_with_output(
            jax.random.PRNGKey(0), x)[0], jnp.asarray(exc)).shape
        assert length == jshape[1] == frames * rate, (i, length, jshape)
    with pytest.raises(ValueError, match="needs its excitation"):
        port(t(hidden))
    plain = th.Generator(16, **common)
    assert not any(k.startswith("exc") for k in plain.state_dict())
    with pytest.raises(ValueError, match="built without nsf"):
        plain(t(hidden), t(exc))


MODES = {
    "predict_nsf": dict(nsf=True),
    "score_nsf": dict(nsf=True, f0_mode="score"),
    "residual_nsf": dict(nsf=True, f0_residual=True),
    "residual": dict(f0_residual=True),
}


def _configs(nsf=False, f0_residual=False, f0_mode="predict"):
    """(JAX SVSConfig, port SVSConfig) of the tiny trainer, the same
    values."""
    jcfg = dataclasses.replace(j_configs.build_svs_config(
        tiny=True, nsf=nsf, f0_residual=f0_residual), f0_mode=f0_mode)
    cfg = dataclasses.replace(build_svs_config(
        tiny=True, nsf=nsf, f0_residual=f0_residual), f0_mode=f0_mode)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} \
        == {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    return jcfg, cfg


@pytest.fixture(scope="module")
def batch():
    b = j_data.synthetic_batch(_configs()[0], batch=2, t_phones=8,
                               t_frames=32, seed=0)
    b["note_ids"][0, 3] = 0                                 # a rest
    return b


@pytest.fixture(scope="module")
def nsf_params(batch):
    """A numpy-seeded tree of the NSF training __call__ (spec_encoder and
    the exc convs included)."""
    jm = jv.VISinger(_configs(nsf=True)[0])
    return init_params(jm, 5, *_gen_args(batch), deterministic=True,
                       log_f0=batch["log_f0"])


def _pair(params, **kw):
    """(JAX model, its tree, port model) of the tiny config with ``kw``:
    without nsf the exc convs are dropped from the tree."""
    jcfg, cfg = _configs(**kw)
    if not cfg.nsf:
        params = {"params": {**params["params"], "decoder": {
            k: v for k, v in params["params"]["decoder"].items()
            if not k.startswith("exc_")}}}
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg))
    return jv.VISinger(jcfg), params, port.eval()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_visinger_infer_matches_flax(mode, batch, nsf_params):
    """VISinger.infer with pinned durations and injected noise: the frame
    F0 the source follows, the source and the audio."""
    jm, params, port = _pair(nsf_params, **MODES[mode])
    cfg = port.cfg
    rng = np.random.RandomState(11)
    noise = rng.randn(2, 32, cfg.inter_channels).astype(np.float32)
    ph_dur = rng.randint(2, 5, (2, 8)).astype(np.int32)
    score = {k: batch[k] for k in ("phones", "x_lengths", "note_ids",
                                   "note_durations", "shengdiao")}
    audio_j, len_j, aux_j = jm.apply(params, **score, max_frames=32,
                                     noise=noise, ph_dur=ph_dur,
                                     method=jv.VISinger.infer)
    with torch.no_grad():
        audio_t, len_t, aux_t = port.infer(
            *(t(score[k]) for k in ("phones", "x_lengths", "note_ids",
                                    "note_durations", "shengdiao")), 32,
            noise=t(noise), ph_dur=t(ph_dur))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    used_j = np.asarray(aux_j["log_f0_used"])
    used_t = aux_t["log_f0_used"].numpy()
    np.testing.assert_allclose(used_t, used_j, rtol=0, atol=LF0_TOL)
    assert ("exc" in aux_t) == ("exc" in aux_j) == cfg.nsf
    if cfg.nsf:
        exc_t = aux_t["exc"].numpy()
        tol = _phase_tol(_phase_f64(used_j, cfg.hop_length))
        np.testing.assert_allclose(exc_t, np.asarray(aux_j["exc"]), rtol=0,
                                   atol=2 * np.pi * je.EXC_AMPLITUDE * 2
                                   * tol)
    assert rel_err(audio_t.numpy(), np.asarray(audio_j)) <= FWD_TOL
    valid = np.arange(32)[None] < len_t.numpy()[:, None]
    hz = tv.note_hz_frames(t(score["note_ids"]), t(ph_dur), 32) * t(valid)
    base, hz = torch.log1p(hz).numpy(), hz.numpy()
    if cfg.f0_mode == "score":
        # the score's pitch exactly, 0 at rests and past the end; voiced
        # except at rests, so the source is not silent
        np.testing.assert_array_equal(used_t, base)
        voiced = used_t[valid] > te.VOICED_LOG_F0_MIN
        assert voiced.mean() > 0.5 and np.all(voiced == (hz[valid] > 0))
        assert np.sqrt(np.mean(exc_t ** 2)) > 0.01


def test_residual_head_starts_on_pitch():
    """A fresh residual model (zero-initialised output conv) predicts the
    note's log1p-F0 exactly; the absolute head does not."""
    rng = np.random.RandomState(2)
    notes = t(rng.randint(48, 80, (1, 8)).astype(np.int32))
    ph_dur = torch.full((1, 8), 4, dtype=torch.int32)
    args = (t(np.arange(3, 11, dtype=np.int32)[None]),
            torch.tensor([8], dtype=torch.int32), notes,
            torch.full((1, 8), 0.1), torch.zeros((1, 8), dtype=torch.int32))
    want = torch.log1p(tv.note_hz_frames(notes, ph_dur, 32))
    for residual in (True, False):
        torch.manual_seed(0)
        model = tv.VISinger(build_svs_config(tiny=True, nsf=True,
                                             f0_residual=residual)).eval()
        with torch.no_grad():
            _, _, aux = model.infer(*args, 32, ph_dur=ph_dur)
        err = (aux["log_f0"] - want).abs().max()
        assert (err <= LF0_TOL) if residual else (err > 0.1)


@pytest.fixture(scope="module")
def jax_loss_and_grads(batch, nsf_params):
    """The JAX nsf + f0_residual model's generator loss terms that need no
    discriminator (losses.*, as the JAX trainer composes them), its
    forward outputs and the gradient of every generator parameter, as one
    jitted function of the batch, and the draws it was traced with.
    Dataset durations: the MAS case feeds it the MAS targets as the
    batch's durations, which gives the use_mas forward exactly (MAS's
    output is a constant of the graph)."""
    jm, params, _ = _pair(nsf_params, nsf=True, f0_residual=True)
    cfg = jm.cfg
    rng = np.random.RandomState(12)
    shape = (2, 32, cfg.inter_channels)
    draws = {"noise": rng.randn(*shape).astype(np.float32),
             "noise_rev": rng.randn(*shape).astype(np.float32),
             "slice_u": rng.uniform(0, 1, (2,)).astype(np.float32)}

    def loss(gp, batch):
        out = jm.apply({"params": gp}, *_gen_args(batch),
                       deterministic=True, log_f0=batch["log_f0"],
                       rngs={"noise": jax.random.PRNGKey(0),
                             "slice": jax.random.PRNGKey(1)})
        y_real = j_slice(batch["audio"], out["ids_slice"] * cfg.hop_length,
                         cfg.segment_size)
        audio = out["audio"][..., 0]
        m = {"loss_mel": jl.l1_masked(
            j_mel(audio, cfg.sampling_rate, hop=cfg.hop_length),
            j_mel(y_real[..., 0], cfg.sampling_rate, hop=cfg.hop_length))}
        m["loss_kl"] = jl.kl_divergence(out["z_p"], out["logs_q"],
                                        out["m_p"], out["logs_p"],
                                        out["y_mask"])
        m["loss_kl_rev"] = jl.gaussian_nll(
            out["z_hat"], jax.lax.stop_gradient(out["m_q"]),
            jax.lax.stop_gradient(out["logs_q"]), out["y_mask"])
        m["loss_dur"] = jl.duration_loss(
            out["duration_fraction"], batch["note_durations"],
            out["duration_targets"], cfg.frame_seconds, out["x_mask"][..., 0])
        m["loss_f0"] = jl.f0_loss(out["log_f0"], batch["log_f0"],
                                  out["y_mask"][..., 0])
        m["loss_energy"] = jl.energy_loss(audio, y_real[..., 0])
        m["loss_spec"] = jl.l1_masked(out["spec_predict"], batch["spec"],
                                      out["y_mask"])
        return sum(m.values()), (m, out)

    gp = params["params"]
    with jax_draws(draws):
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
            gp, batch).compile()
    return (lambda b: fn(gp, b)), draws


def _port_light_loss(cfg, out, batch):
    y_real = slice_segments(batch["audio"], out["ids_slice"] * cfg.hop_length,
                            cfg.segment_size)
    audio = out["audio"][..., 0]
    m = {"loss_mel": tl.l1_masked(
        t_mel(audio, cfg.sampling_rate, hop=cfg.hop_length),
        t_mel(y_real[..., 0], cfg.sampling_rate, hop=cfg.hop_length))}
    m["loss_kl"] = tl.kl_divergence(out["z_p"], out["logs_q"], out["m_p"],
                                    out["logs_p"], out["y_mask"])
    m["loss_kl_rev"] = tl.gaussian_nll(out["z_hat"], out["m_q"].detach(),
                                       out["logs_q"].detach(), out["y_mask"])
    m["loss_dur"] = tl.duration_loss(
        out["duration_fraction"], batch["note_durations"],
        out["duration_targets"], cfg.frame_seconds, out["x_mask"][..., 0])
    m["loss_f0"] = tl.f0_loss(out["log_f0"], batch["log_f0"],
                              out["y_mask"][..., 0])
    m["loss_energy"] = tl.energy_loss(audio, y_real[..., 0])
    m["loss_spec"] = tl.l1_masked(out["spec_predict"], batch["spec"],
                                  out["y_mask"])
    return sum(m.values()), m


@pytest.mark.parametrize("durations", ["dataset", "mas"])
def test_forward_losses_and_grads_match_jax(durations, batch, nsf_params,
                                            jax_loss_and_grads):
    """VISinger.forward with nsf and f0_residual, under the batch's and
    MAS durations: the outputs, the loss terms and the gradient of every
    generator parameter. The source comes from the batch's log_f0, sliced
    beside the latent; the residual base is expanded by the durations
    that drove the length regulator."""
    jax_fn, draws = jax_loss_and_grads
    _, _, port = _pair(nsf_params, nsf=True, f0_residual=True)
    tb = {k: t(v) for k, v in batch.items()}
    plain = maximum_path.plain_calls
    mas = durations == "mas"
    out_t = port(*(tb[k] for k in ("phones", "x_lengths", "spec",
                                   "y_lengths", "note_ids", "note_durations",
                                   "f0_score", "phone_durations",
                                   "shengdiao")),
                 deterministic=True, use_mas=mas, log_f0=tb["log_f0"],
                 **{k: t(v) for k, v in draws.items()})
    assert maximum_path.plain_calls == plain + mas
    targets = out_t["duration_targets"].numpy()
    if mas:
        np.testing.assert_array_equal(targets.sum(1), batch["y_lengths"])
        assert not np.array_equal(targets, batch["phone_durations"])
    (_, (metrics_j, out_j)), grads_j = jax_fn(
        {**batch, "phone_durations": targets})
    np.testing.assert_array_equal(targets,
                                  np.asarray(out_j["duration_targets"]))
    np.testing.assert_array_equal(out_t["ids_slice"].numpy(),
                                  np.asarray(out_j["ids_slice"]))
    for key in ("audio", "log_f0", "z_hat", "spec_predict", "m_p"):
        assert rel_err(out_t[key].detach().numpy(),
                       np.asarray(out_j[key])) <= FWD_TOL, key
    total, metrics_t = _port_light_loss(port.cfg, out_t, tb)
    for k, v in metrics_j.items():
        assert rel_err(metrics_t[k].detach(), v) <= FWD_TOL, k
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(total,
                                                list(port.parameters()))))
    _assert_grads(grads, visinger_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads_j), port.cfg), GRAD_TOL)
    for i in range(len(port.cfg.upsample_rates)):
        assert np.linalg.norm(grads[f"decoder.exc.{i}.weight"]) > 0


def test_forward_refuses_nsf_without_log_f0(batch, nsf_params):
    _, _, port = _pair(nsf_params, nsf=True)
    tb = {k: t(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="log_f0"):
        port(*(tb[k] for k in ("phones", "x_lengths", "spec", "y_lengths",
                               "note_ids", "note_durations", "f0_score",
                               "phone_durations", "shengdiao")),
             deterministic=True)


BF16_DECODERS = {"hifigan": TINY, "istft": TINY_ISTFT, "mb_istft": TINY_MB}


@pytest.mark.parametrize("decoder", sorted(BF16_DECODERS))
def test_bf16_decoder_close_to_jax_and_float32(decoder):
    """VISinger.decode_hidden with decoder_bf16 on each decoder family:
    float32 out, within the relative-MAE bound of JAX's bf16 decode and of
    the port's float32 one; the parameters stay float32."""
    jcfg = BF16_DECODERS[decoder]
    cfg = dataclasses.replace(build_svs_config(tiny=True, decoder=decoder),
                              decoder_bf16=True)
    hidden = np.random.RandomState(9).randn(2, 24, 16).astype(np.float32)
    jdec = (jh.Generator(
        resblock_kernel_sizes=jcfg.resblock_kernel_sizes,
        resblock_dilation_sizes=jcfg.resblock_dilation_sizes,
        upsample_rates=jcfg.upsample_rates,
        upsample_initial_channel=jcfg.upsample_initial_channel,
        upsample_kernel_sizes=jcfg.upsample_kernel_sizes)
        if decoder == "hifigan" else _jax_decoder(jcfg))
    params = init_params(jdec, 4, jnp.asarray(hidden))
    jm = jv.VISinger(dataclasses.replace(jcfg, decoder_bf16=True))
    want = np.asarray(jm.apply({"params": {"decoder": params["params"]}},
                               jnp.asarray(hidden),
                               method=jv.VISinger.decode_hidden))
    port = tv.VISinger(cfg).eval()
    port.decoder.load_state_dict(state_dict_from_flax(params, port.decoder))
    with torch.no_grad():
        got = port.decode_hidden(t(hidden))
        f32 = port.decoder(t(hidden))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert all(v.dtype == torch.float32 for v in port.state_dict().values())
    got, f32 = got.numpy(), f32.numpy()
    assert got.shape == want.shape == f32.shape == (2, 24 * 16, 1)
    for ref in (want, f32):
        assert np.abs(got - ref).mean() / np.abs(ref).mean() < BF16_REL_MAE
    assert not np.array_equal(got, f32)        # bf16 really ran


def test_nsf_tree_converts_strictly(nsf_params):
    """A JAX NSF tree maps onto the port's nsf VISinger with every leaf
    consumed (decoder/exc_{i}/{kernel,bias} -> decoder.exc.{i}); the
    plain config refuses the exc leaves."""
    _, cfg = _configs(nsf=True)
    sd = visinger_state_dict_from_flax(nsf_params, cfg)
    assert sorted(k for k in sd if ".exc." in k) == [
        f"decoder.exc.{i}.{p}" for i in range(2) for p in ("bias", "weight")]
    exc0 = nsf_params["params"]["decoder"]["exc_0"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.exc.0.weight"].numpy(),
                                  np.transpose(exc0, (2, 1, 0)))
    with pytest.raises(ValueError, match="exc_0"):
        visinger_state_dict_from_flax(nsf_params, _configs()[1])


def test_reference_import_refuses_nsf():
    _, cfg = _configs(nsf=True)
    with pytest.raises(ValueError, match="NSF"):
        visinger_state_dict_from_torch({"spec_decoder.pre.weight":
                                        np.zeros((1, 1, 1))}, cfg)


@pytest.mark.parametrize("decoder", ["istft", "mb_istft"])
def test_nsf_needs_hifigan(decoder, capsys):
    """build_svs_config, the train CLI and the server refuse --nsf with an
    iSTFT decoder (exit 2 from the CLIs, at parse time)."""
    with pytest.raises(ValueError, match="hifigan"):
        build_svs_config(tiny=True, decoder=decoder, nsf=True)
    for main in (train_main, t_app.main):
        with pytest.raises(SystemExit) as e:
            main(["--tiny", "--device", "cpu", "--nsf", "--decoder",
                  decoder])
        assert e.value.code == 2
        assert "--nsf requires --decoder hifigan" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--nsf", "--f0", "score"],
                                   ["--decoder-bf16", "--decoder",
                                    "mb_istft"]])
def test_server_builds_variant(flags):
    """serve.app's configure + build_songs with the SVS flags: every
    singer's config carries them, and a song comes out."""
    args, cfg = t_app.configure(["--tiny", "--device", "cpu"] + flags)
    songs = t_app.build_songs(args, cfg)
    want = dict(nsf="--nsf" in flags, decoder_bf16="--decoder-bf16" in flags,
                f0_mode="score" if "score" in flags else "predict",
                decoder_type=args.decoder)
    for svs in songs.synthesizers.values():
        assert {k: getattr(svs.cfg, k) for k in want} == want
    rate, wav = wavfile.read(io.BytesIO(
        songs.synthesize_song("你好世界").wav_bytes))
    assert rate == 22050 and wav.dtype == np.int16 and np.any(wav != 0)


def test_plain_pipeline_loads_into_nsf_server(tmp_path, caplog):
    """load_pipeline of a pipeline saved without NSF into --nsf songs: one
    WARNING with the counts, every shared tensor restored, the exc convs
    kept at their init."""
    from music_generation_tpu_torch.compat import load_pipeline, save_pipeline
    plain = t_app.build_songs(*t_app.configure(["--tiny", "--device",
                                                "cpu"]), seed=3)
    save_pipeline(str(tmp_path), plain)
    songs = t_app.build_songs(*t_app.configure(["--tiny", "--device", "cpu",
                                                "--nsf"]))
    model = songs.synthesizers[0].model
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level("WARNING", logger="music_generation_tpu_torch"):
        load_pipeline(str(tmp_path), songs)
    n_exc = sum(".exc." in k for k in init)
    assert n_exc == 8
    assert f"{len(init) - n_exc} tensors restored, {n_exc} kept at init, " \
        "0 in the file unused" in caplog.text
    want = plain.synthesizers[0].model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k] if ".exc." in k else want[k]), k


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesis_music",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_train_export_serve_nsf_residual(tmp_path, monkeypatch):
    """python -m music_generation_tpu_torch.train --tiny --device cpu --nsf
    --f0-residual --durations mas --steps 2, then
    tools/torch_export_trained_svs.py --nsf --f0-residual, then serve.app's
    main() with --nsf --f0-residual --checkpoint-dir: a text request
    answers 200. The tiny trainer (hop 16) and the tiny server (hop 256)
    differ, so the load keeps the tensors of other shapes at init and
    restores the rest."""
    from tools.torch_export_trained_svs import main as export_main
    ck, served = tmp_path / "ck", tmp_path / "served"
    plain = maximum_path.plain_calls
    train_main(["--tiny", "--device", "cpu", "--nsf", "--f0-residual",
                "--durations", "mas", "--steps", "2", "--batch-size", "2",
                "--warmup-steps", "0", "--log-every", "1", "--ckpt-dir",
                str(ck)])
    assert maximum_path.plain_calls == plain + 4
    gen = torch.load(ck / "step_2.pt", weights_only=True)["gen"]
    assert {"decoder.exc.0.weight", "decoder.exc.1.weight"} <= set(gen)
    export_main(["--ckpt", str(ck / "step_2.pt"), "--out", str(served),
                 "--tiny", "--nsf", "--f0-residual", "--speakers", "0", "1",
                 "2"])
    with pytest.raises(SystemExit):     # the plain config refuses the file
        export_main(["--ckpt", str(ck / "step_2.pt"), "--out",
                     str(tmp_path / "x"), "--tiny"])
    monkeypatch.chdir(tmp_path)
    make_server, seen = t_app.make_http_server, []

    def free_port_server(service, host, port, **tls):
        srv = make_server(service, "127.0.0.1", 0, **tls)

        def request():
            try:
                seen.append(_post(srv.server_address[1],
                                  {"text": "你好世界"}))
            finally:
                srv.shutdown()
        seen.append(service)
        threading.Thread(target=request, daemon=True).start()
        return srv

    monkeypatch.setattr(t_app, "make_http_server", free_port_server)
    t_app.main(["--tiny", "--device", "cpu", "--nsf", "--f0-residual",
                "--checkpoint-dir", str(served)])
    service, out = seen
    assert out["code"] == 200, out
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16 and np.any(wav != 0)
    for svs in service.songs.synthesizers.values():
        assert svs.cfg.nsf and svs.cfg.f0_residual
        state = svs.model.state_dict()
        restored = [k for k, v in gen.items()
                    if state[k].shape == v.shape]
        assert "text_encoder.emb_phoneme.weight" in restored
        assert all(torch.equal(state[k], gen[k]) for k in restored)
    shutil.rmtree(ck)  # the step file with the discriminator's, 0.5 GB

