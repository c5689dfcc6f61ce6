"""The plain (non-AE) VISinger, the spectrogram probes and speaker
conditioning of the PyTorch port vs the JAX package (CPU, tiny configs).

- VISinger(autoencoder=False): infer (pinned durations, injected prior
  noise) and the training forward (injected draws) against flax;
- infer_fake (whole and cut to max_len), copy_synthesis (AE, plain, NSF)
  and voice_conversion (gin_channels > 0, g_src == g_tgt and g_src !=
  g_tgt) against flax on the same injected posterior noise;
- the cond convs through compat.from_jax;
- the reference's plain models.py file through compat.torch_import and
  tools/torch_import_pipeline.py --no-autoencoder, served by a pipeline
  that rebuilds the singer as the file's variant; both refusals;
- the plain trainer step (no loss_spec, MAS durations);
- SVSSynthesizer.synthesize_pipe_format and the CLI's --score.
Weights are numpy-seeded unit-scale trees carried across by the mappers.
Tolerances: audio, z and the flow's images within 1e-4 relative L2 (the
existing port tests' FWD_TOL); a round trip through the flow (g_src ==
g_tgt) within 1e-4 of z.
"""

import contextlib
import dataclasses
import io
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.compat.torch_import import (
    visinger_params_from_torch)
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu.pipeline import synthesis as j_syn
from music_generation_tpu.train import data as j_data
from music_generation_tpu_torch.compat import (load_pipeline,
                                               visinger_state_dict_from_flax,
                                               visinger_state_dict_from_torch)
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.ops import maximum_path
from music_generation_tpu_torch.pipeline import __main__ as t_cli
from music_generation_tpu_torch.pipeline import synthesis as t_syn
from music_generation_tpu_torch.train import (TrainConfig, create_states,
                                              make_train_step,
                                              synthetic_batch)
from test_istft_decoder import TINY
from test_torch_checkpoints import _flax_visinger, reference_state_dict
from test_torch_train import _gen_args, jax_draws
from torch_port_util import (init_params, rel_err, same_config, t,
                             tiny_songs)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_import_pipeline  # noqa: E402

FWD_TOL = 1e-4
GIN = 8
PLAIN = dataclasses.replace(TINY, autoencoder=False)
SPEAKERS = dataclasses.replace(TINY, gin_channels=GIN)
JCFGS = {"ae": TINY, "plain": PLAIN,
         "nsf": dataclasses.replace(TINY, nsf=True)}


@pytest.fixture(scope="module")
def batch():
    return j_data.synthetic_batch(TINY, batch=2, t_phones=8, t_frames=32,
                                  seed=0)


def _port(jcfg, params):
    """The port's VISinger of ``jcfg`` with the tree's weights; a tree
    without some submodules leaves them at init (strict=False)."""
    cfg = same_config(tv.SVSConfig, jcfg)
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg,
                                                       strict=False),
                         strict=False)
    return port.eval()


def _spec_inputs(batch, jcfg, seed=21):
    rng = np.random.RandomState(seed)
    y_lengths = np.array([32, 23], np.int32)
    noise = rng.randn(2, 32, jcfg.inter_channels).astype(np.float32)
    log_f0 = np.log1p(rng.uniform(80, 400, (2, 32))).astype(np.float32)
    return batch["spec"], y_lengths, noise, log_f0


def run_jax(fn, *args):
    """fn(*args) jitted with XLA's backend optimisations off, which halves
    the CPU compile of these small programs."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@contextlib.contextmanager
def jax_posterior_noise(noise):
    """While the JAX reference traces, jax.random.normal gives ``noise``
    (the posterior draw of voice_conversion)."""
    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype)
    with mock.patch.object(jax.random, "normal", normal):
        yield


# ---- the plain VISinger -----------------------------------------------------

def test_plain_visinger_infer_and_forward_match_flax(batch):
    """VISinger(autoencoder=False) has no spec_decoder or spec_proj: infer
    decodes z itself, and the training forward slices z for the vocoder
    and returns no spec_predict. (Weights: the training __call__'s tree,
    every submodule.)"""
    jm = jv.VISinger(PLAIN)
    score = {k: batch[k] for k in ("phones", "x_lengths", "note_ids",
                                   "note_durations", "shengdiao")}
    # the training tree: infer's and the posterior encoder's
    params = init_params(jm, 5, **score, max_frames=32,
                         method=jv.VISinger.infer)
    params["params"]["spec_encoder"] = init_params(
        jv.PosteriorEncoder(PLAIN), 6, batch["spec"],
        np.ones((2, 32, 1), np.float32))["params"]
    cfg = same_config(tv.SVSConfig, PLAIN)
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg))
    port.eval()
    assert "spec_decoder" not in params["params"]
    assert not any(k.startswith(("spec_decoder", "spec_proj"))
                   for k in port.state_dict())
    rng = np.random.RandomState(11)
    noise = rng.randn(2, 32, PLAIN.inter_channels).astype(np.float32)
    ph_dur = rng.randint(1, 4, (2, 8)).astype(np.int32)
    shape = (2, 32, PLAIN.inter_channels)
    draws = {"noise": rng.randn(*shape).astype(np.float32),
             "noise_rev": rng.randn(*shape).astype(np.float32),
             "slice_u": rng.uniform(0, 1, (2,)).astype(np.float32)}

    def both(p):
        infer = jm.apply(p, **score, max_frames=32, noise=noise,
                         ph_dur=ph_dur, method=jv.VISinger.infer)
        fwd = jm.apply(p, *_gen_args(batch), deterministic=True,
                       rngs={"noise": jax.random.PRNGKey(0),
                             "slice": jax.random.PRNGKey(1)})
        return infer, fwd
    with jax_draws(draws):
        (audio_j, len_j, aux_j), out_j = run_jax(both, params)
    with torch.no_grad():
        audio_t, len_t, aux_t = port.infer(
            *(t(score[k]) for k in ("phones", "x_lengths", "note_ids",
                                    "note_durations", "shengdiao")),
            32, noise=t(noise), ph_dur=t(ph_dur))
        out_t = port(*(t(a) for a in _gen_args(batch)), deterministic=True,
                     **{k: t(v) for k, v in draws.items()})
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert aux_j["spec_predict"] is None and aux_t["spec_predict"] is None
    assert rel_err(audio_t.numpy(), np.asarray(audio_j)) <= FWD_TOL
    assert out_j["spec_predict"] is None and out_t["spec_predict"] is None
    np.testing.assert_array_equal(out_t["ids_slice"].numpy(),
                                  np.asarray(out_j["ids_slice"]))
    for key in ("audio", "z", "z_hat", "mel_predict"):
        assert rel_err(out_t[key].numpy(), np.asarray(out_j[key])) \
            <= FWD_TOL, key


# ---- infer_fake, copy_synthesis, voice_conversion ---------------------------

def _all_probes(m, spec, y_len, g_src, g_tgt):
    """Every probe, so that one init holds every submodule they use."""
    return (m.voice_conversion(spec, y_len, g_src, g_tgt),
            m.copy_synthesis(spec, y_len))


@pytest.fixture(scope="module")
def speakers(batch):
    """The AE speaker model (gin_channels > 0, no NSF): (port model,
    params, inputs, the JAX outputs of infer_fake whole and cut to 24
    frames, copy_synthesis, and voice_conversion to g_src and to another
    speaker), from one jitted JAX program on the same posterior noise."""
    jm = jv.VISinger(SPEAKERS)
    spec, y_len, noise, _ = _spec_inputs(batch, SPEAKERS)
    rng = np.random.RandomState(24)
    g_src = rng.randn(2, 1, GIN).astype(np.float32)
    g_other = rng.randn(2, 1, GIN).astype(np.float32)
    params = init_params(jm, 7, spec, y_len, g_src, g_src,
                         method=_all_probes)
    rngs = {"noise": jax.random.PRNGKey(0)}

    def probes(p):
        return {
            "fake": jm.apply(p, spec, y_len, noise=noise,
                             method=jv.VISinger.infer_fake),
            "fake_24": jm.apply(p, spec, y_len, max_len=24, noise=noise,
                                method=jv.VISinger.infer_fake),
            "copy": jm.apply(p, spec, y_len, noise=noise,
                             method=jv.VISinger.copy_synthesis),
            **{name: jm.apply(p, spec, y_len, g_src, g, rngs=rngs,
                              method=jv.VISinger.voice_conversion)
               for name, g in (("vc_same", g_src), ("vc_other", g_other))}}
    with jax_posterior_noise(noise):
        want = run_jax(probes, params)
    inputs = {"spec": t(spec), "y_len": t(y_len), "noise": t(noise),
              "g_src": t(g_src), "g_other": t(g_other)}
    return _port(SPEAKERS, params), params, inputs, want


def _check_probe(name, got, want, frames, hop):
    audio_t, mask_t, z_t = got
    audio_j, mask_j, z_j = want
    assert audio_t.shape == (2, frames * hop, 1), name
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert rel_err(z_t.numpy(), np.asarray(z_j)) <= FWD_TOL, name
    assert rel_err(audio_t.numpy(), np.asarray(audio_j)) <= FWD_TOL, name


def test_infer_fake_matches_flax(speakers):
    """The reference's copy synthesis: posterior z straight into the
    vocoder (the AE spec decoder bypassed), whole and cut to max_len
    frames with its mask."""
    port, _, x, want = speakers
    with torch.no_grad():
        for name, max_len in (("fake", None), ("fake_24", 24)):
            got = port.infer_fake(x["spec"], x["y_len"], max_len=max_len,
                                  noise=x["noise"])
            _check_probe(name, got, want[name], max_len or 32,
                         SPEAKERS.hop_length)


def test_copy_synthesis_matches_flax(speakers):
    """Posterior z through the trained decode path (the AE spec decoder and
    spec_proj): not infer_fake's bypass."""
    port, _, x, want = speakers
    with torch.no_grad():
        got = port.copy_synthesis(x["spec"], x["y_len"], noise=x["noise"])
    _check_probe("copy", got, want["copy"], 32, SPEAKERS.hop_length)
    assert rel_err(np.asarray(want["copy"][0]),
                   np.asarray(want["fake"][0])) > 1e-2


def test_nsf_probes_match_flax(batch):
    """Under NSF the source comes from log_f0: infer_fake cut to max_len
    frames slices it with z; copy_synthesis passes it whole."""
    jcfg = JCFGS["nsf"]
    jm = jv.VISinger(jcfg)
    spec, y_len, noise, log_f0 = _spec_inputs(batch, jcfg)
    params = init_params(jm, 5, spec, y_len, log_f0=log_f0,
                         method=jv.VISinger.copy_synthesis)
    port = _port(jcfg, params)

    def probes(p):
        return (jm.apply(p, spec, y_len, max_len=24, noise=noise,
                         log_f0=log_f0, method=jv.VISinger.infer_fake),
                jm.apply(p, spec, y_len, noise=noise, log_f0=log_f0,
                         method=jv.VISinger.copy_synthesis))
    want = run_jax(probes, params)
    with torch.no_grad():
        got = (port.infer_fake(t(spec), t(y_len), max_len=24,
                               noise=t(noise), log_f0=t(log_f0)),
               port.copy_synthesis(t(spec), t(y_len), noise=t(noise),
                                   log_f0=t(log_f0)))
    for name, frames, g, w in zip(("infer_fake", "copy_synthesis"),
                                  (24, 32), got, want):
        _check_probe(name, g, w, frames, jcfg.hop_length)


def test_plain_copy_synthesis_is_the_bypass(batch):
    """In the plain variant the trained decode path is z itself, so
    copy_synthesis and infer_fake give the same waveform (as in the JAX
    package, where both decode z * mask)."""
    port = tv.VISinger(same_config(tv.SVSConfig, PLAIN)).eval()
    spec, y_len, noise, _ = _spec_inputs(batch, PLAIN)
    with torch.no_grad():
        copy = port.copy_synthesis(t(spec), t(y_len), noise=t(noise))
        fake = port.infer_fake(t(spec), t(y_len), noise=t(noise))
    assert torch.equal(copy[0], fake[0]) and torch.equal(copy[2], fake[2])


@pytest.mark.parametrize("target", ["same", "other"])
def test_voice_conversion_matches_flax(target, speakers):
    """gin_channels > 0: the posterior and the forward flow under g_src,
    the inverse flow and the vocoder under g_tgt; with g_tgt == g_src the
    round trip gives z back, with another speaker it does not."""
    port, _, x, want = speakers
    g_tgt = x["g_src"] if target == "same" else x["g_other"]
    with torch.no_grad():
        audio_t, _, zs_t = port.voice_conversion(
            x["spec"], x["y_len"], x["g_src"], g_tgt, noise=x["noise"])
    audio_j, _, zs_j = want[f"vc_{target}"]
    for name, got, ref in zip(("z", "z_p", "z_hat"), zs_t, zs_j):
        assert rel_err(got.numpy(), np.asarray(ref)) <= FWD_TOL, name
    assert rel_err(audio_t.numpy(), np.asarray(audio_j)) <= FWD_TOL
    z, _, z_hat = zs_t
    if target == "same":
        assert rel_err(z_hat.numpy(), z.numpy()) <= FWD_TOL
    else:
        assert rel_err(z_hat.numpy(), z.numpy()) > 10 * FWD_TOL


def test_cond_convs_map_from_flax(speakers, batch):
    """The cond leaves of a flax tree initialised through
    voice_conversion land on the port's cond convs (kernel [K, I, O] ->
    [O, I, K], a weight norm's g as it is); a port config without
    gin_channels refuses them as unconsumed leaves, and speaker
    conditioning given to it raises."""
    port, params, _, _ = speakers
    sd = port.state_dict()
    p = params["params"]
    for port_name, leaves in (
            ("spec_encoder.enc.cond", p["spec_encoder"]["enc"]["cond"]),
            ("spec_flow.coupling.2.enc.cond",
             p["spec_flow"]["coupling_2"]["enc"]["cond"]),
            ("decoder.cond", p["decoder"]["cond"])):
        np.testing.assert_array_equal(
            sd[f"{port_name}.weight"].numpy(),
            np.transpose(leaves["kernel"], (2, 1, 0)))
        np.testing.assert_array_equal(sd[f"{port_name}.bias"].numpy(),
                                      leaves["bias"])
    np.testing.assert_array_equal(sd["spec_encoder.enc.cond.g"].numpy(),
                                  p["spec_encoder"]["enc"]["cond"]["g"])
    assert "decoder.cond.g" not in sd          # a plain 1x1 conv
    with pytest.raises(ValueError, match="cond"):
        visinger_state_dict_from_flax(params, same_config(tv.SVSConfig,
                                                          TINY),
                                      strict=False)
    plain = tv.VISinger(same_config(tv.SVSConfig, TINY)).eval()
    spec, y_len, noise, _ = _spec_inputs(batch, TINY)
    g = torch.zeros(2, 1, GIN)
    with pytest.raises(ValueError, match="gin_channels=0"):
        plain.voice_conversion(t(spec), t(y_len), g, g, noise=t(noise))


# ---- the reference's plain models.py file -----------------------------------

@pytest.fixture(scope="module")
def plain_reference():
    """(config, synthetic reference state_dict) of the plain variant: the
    tiny served config with the reference's three convs per ResBlock1 (the
    JAX key table's count)."""
    cfg = dataclasses.replace(t_syn.tiny_configs(0)[1],
                              resblock_dilation_sizes=((1, 3, 5),),
                              autoencoder=False)
    sd, _ = reference_state_dict(_flax_visinger(cfg, 4),
                                 len(cfg.resblock_kernel_sizes))
    return cfg, sd


def test_reference_plain_import_and_refusals(plain_reference):
    """The port's import of a plain reference state_dict under
    autoencoder=False equals the flax mapper on the JAX package's import
    of it; the plain file into the AE config and an AE file into the plain
    config are refused, naming the flag."""
    cfg, sd = plain_reference
    assert not any(k.startswith(("spec_decoder", "spec_proj")) for k in sd)
    want = visinger_state_dict_from_flax(
        visinger_params_from_torch(sd, same_config(jv.SVSConfig, cfg)), cfg)
    got = visinger_state_dict_from_torch(sd, cfg)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="--no-autoencoder"):
        visinger_state_dict_from_torch(
            sd, dataclasses.replace(cfg, autoencoder=True))
    # an AE file is told apart by its spec_decoder tensors
    ae_sd = {**sd, "spec_decoder.pre.weight": np.zeros((1, 1, 1))}
    with pytest.raises(ValueError, match="autoencoder=True"):
        visinger_state_dict_from_torch(ae_sd, cfg)


def test_reference_plain_pth_served(plain_reference, tmp_path, capsys):
    """torch_import_pipeline --pth --no-autoencoder --tiny writes svs_0.pt
    of the plain variant (the tiny server's two convs per ResBlock1 taken
    from the file's three); load_pipeline rebuilds the AE server's singer
    as that variant and every tensor equals the file's; the song is
    served. The tool without --no-autoencoder exits 2 naming the flag."""
    _, sd = plain_reference
    pth = tmp_path / "G.pth"
    torch.save({"model": sd, "iteration": 3}, pth)
    out = tmp_path / "port"
    torch_import_pipeline.main(["--pth", str(pth), "--no-autoencoder",
                                "--out", str(out), "--tiny"])
    with pytest.raises(SystemExit) as e:
        torch_import_pipeline.main(["--pth", str(pth), "--out",
                                    str(tmp_path / "x"), "--tiny"])
    assert e.value.code == 2 and "--no-autoencoder" in capsys.readouterr().err
    songs = t_syn.build_default_song_synthesizer(tiny=True, n_speakers=1,
                                                 device="cpu")
    svs = songs.synthesizers[0]
    assert svs.cfg.autoencoder
    assert load_pipeline(str(out), songs) == ["svs_0.pt"]
    assert not svs.cfg.autoencoder and not svs.model.cfg.autoencoder
    saved = torch.load(out / "svs_0.pt", weights_only=True)
    served = svs.model.state_dict()
    assert saved.keys() == served.keys()
    assert all(torch.equal(saved[k], served[k]) for k in saved)
    result = songs.synthesize_song("你好世界")
    _, wav = wavfile.read(io.BytesIO(result.wav_bytes))
    assert len(wav) > int(0.2 * 22050) and np.any(wav != 0)


# ---- training the plain variant ---------------------------------------------

def test_plain_train_step_has_no_spec_loss():
    """One tiny GAN step of the plain variant with MAS durations: finite
    losses, no loss_spec (the JAX trainer adds it only for the AE
    variant), MAS run twice (the plain version on the CPU)."""
    cfg = same_config(tv.SVSConfig, PLAIN)
    tc = TrainConfig(use_mas=True)
    gen_state, disc_state = create_states(cfg, tc, device="cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in
         synthetic_batch(cfg, batch=2, t_phones=8, t_frames=32).items()}
    maximum_path.plain_calls = 0
    metrics = make_train_step(cfg, tc)(gen_state, disc_state, b,
                                       torch.Generator().manual_seed(0))
    assert "loss_spec" not in metrics and "loss_mel" in metrics
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert maximum_path.plain_calls == 2


# ---- pipe-format score lines and the CLI ------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def synthesize(self, *args):
        self.calls.append(args)
        return np.zeros(4)


@pytest.mark.parametrize("line", ["t|啊|C4|0.5",
                                  "name|小 小 的 天|C4 D4 rest E4|0.3 0.4 "
                                  "0.2 0.5"])
def test_synthesize_pipe_format_parses_as_jax(line):
    """The line reaches synthesize() as the JAX package's parse hands it:
    lyrics with spaces removed, pitch names, float seconds."""
    got, want = _Recorder(), _Recorder()
    t_syn.SVSSynthesizer.synthesize_pipe_format(got, line)
    j_syn.SVSSynthesizer.synthesize_pipe_format(want, line)
    assert got.calls == want.calls and len(got.calls) == 1


def test_pipe_format_line_through_synthesizer_and_cli(tmp_path, capsys):
    """synthesize_pipe_format gives synthesize()'s waveform for the same
    prior draw; python -m ...pipeline out.wav --score writes the int16 WAV
    of the line, normalised to full scale; --score with --text exits 2."""
    svs = tiny_songs().synthesizers[0]
    line = "t|小小的天|C4 D4 E4 F4|0.3 0.3 0.3 0.5"
    state = svs.generator.get_state()
    wav = svs.synthesize_pipe_format(line)
    svs.generator.set_state(state)
    ref = svs.synthesize("小小的天", ["C4", "D4", "E4", "F4"],
                         [0.3, 0.3, 0.3, 0.5])
    np.testing.assert_array_equal(wav, ref)
    out = tmp_path / "score.wav"
    t_cli.main([str(out), "--score", "t|啊|C4|0.5", "--tiny", "--device",
                "cpu"])
    rate, pcm = wavfile.read(out)
    assert rate == 22050 and pcm.dtype == np.int16 and len(pcm) > 0
    assert np.abs(pcm.astype(np.int32)).max() >= 32700
    with pytest.raises(SystemExit) as e:
        t_cli.main([str(out), "--score", "t|啊|C4|0.5", "--text", "啊"])
    assert e.value.code == 2
    assert "not allowed" in capsys.readouterr().err


@pytest.mark.slow
def test_full_width_probes_match_flax():
    """SVSConfig(gin_channels=256) at full width on [2, 64, 513]:
    infer_fake, copy_synthesis and voice_conversion (g_src != g_tgt)
    against flax within 1e-4 relative L2."""
    jcfg = jv.SVSConfig(gin_channels=256)
    jm = jv.VISinger(jcfg)
    rng = np.random.RandomState(31)
    spec = np.abs(rng.randn(2, 64, jcfg.spec_channels)).astype(np.float32)
    y_len = np.array([64, 50], np.int32)
    noise = rng.randn(2, 64, jcfg.inter_channels).astype(np.float32)
    g_src, g_tgt = (rng.randn(2, 1, 256).astype(np.float32)
                    for _ in range(2))
    params = init_params(jm, 9, spec, y_len, g_src, g_src,
                         method=_all_probes)
    port = _port(jcfg, params)

    def probes(p):
        return (jm.apply(p, spec, y_len, max_len=48, noise=noise,
                         method=jv.VISinger.infer_fake),
                jm.apply(p, spec, y_len, noise=noise,
                         method=jv.VISinger.copy_synthesis),
                jm.apply(p, spec, y_len, g_src, g_tgt,
                         rngs={"noise": jax.random.PRNGKey(0)},
                         method=jv.VISinger.voice_conversion))
    with jax_posterior_noise(noise):
        want = run_jax(probes, params)
    with torch.no_grad():
        got = (port.infer_fake(t(spec), t(y_len), max_len=48,
                               noise=t(noise)),
               port.copy_synthesis(t(spec), t(y_len), noise=t(noise)),
               port.voice_conversion(t(spec), t(y_len), t(g_src), t(g_tgt),
                                     noise=t(noise)))
    for name, g, w in zip(("infer_fake", "copy_synthesis",
                           "voice_conversion"), got, want):
        assert rel_err(g[0].numpy(), np.asarray(w[0])) <= FWD_TOL, name
