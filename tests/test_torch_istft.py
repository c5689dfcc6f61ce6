"""The iSTFT and MB-iSTFT decoders of the PyTorch port vs the JAX package
(CPU, tiny configs).

The functions of models/svs/istft.py on numpy-seeded inputs; the two
generators, VISinger.infer and VISinger.forward with each decoder on the
TINY_ISTFT / TINY_MB configs of tests/test_istft_decoder.py, numpy-seeded
unit-scale weights carried across with compat, the same injected noise.
Tolerances: istft_overlap_add and pqmf_synthesis within 1e-5 (absolute, on
unit-scale inputs), pqmf_filters identical, the generators and VISinger
within 1e-4 relative L2, the decoder's parameter gradients within 1e-3
relative L2 per tensor.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.models.svs import istft as ji
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu_torch.compat import (state_dict_from_flax,
                                               visinger_state_dict_from_flax)
from music_generation_tpu_torch.models.svs import istft as ti
from music_generation_tpu_torch.models.svs import visinger as tv
from music_generation_tpu_torch.ops import maximum_path
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.train import build_svs_config
from music_generation_tpu_torch.train.__main__ import main as train_main
from test_istft_decoder import TINY_ISTFT, TINY_MB
from test_torch_train import _gen_args, jax_draws
from torch_port_util import init_params, rel_err, same_config, t

FN_TOL = 1e-5
FWD_TOL = 1e-4
GRAD_TOL = 1e-3
DECODERS = {"istft": TINY_ISTFT, "mb_istft": TINY_MB}


@pytest.mark.parametrize("n_fft,hop,frames", [(16, 4, 12), (16, 4, 2),
                                               (8, 2, 9)])
def test_istft_overlap_add_matches_jax(n_fft, hop, frames):
    rng = np.random.RandomState(n_fft + frames)
    n_bins = n_fft // 2 + 1
    mag = np.abs(rng.randn(2, frames, n_bins)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, frames, n_bins)).astype(
        np.float32)
    want = np.asarray(ji.istft_overlap_add(jnp.asarray(mag),
                                           jnp.asarray(phase), n_fft, hop))
    got = ti.istft_overlap_add(t(mag), t(phase), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, frames * hop)
    np.testing.assert_allclose(got, want, atol=FN_TOL, rtol=0)


def test_istft_overlap_add_reconstructs_stft():
    """istft(stft(x)) == x away from the edges (the property
    tests/test_istft_decoder.py holds the JAX function to)."""
    n_fft, hop = 16, 4
    x = np.random.RandomState(0).randn(2, 128).astype(np.float32)
    n = (128 - n_fft) // hop + 1
    frames = np.stack([x[:, i * hop: i * hop + n_fft] for i in range(n)], 1)
    spec = np.fft.rfft(frames, axis=-1)
    out = ti.istft_overlap_add(t(np.abs(spec).astype(np.float32)),
                               t(np.angle(spec).astype(np.float32)), n_fft,
                               hop).numpy()
    lo, hi = n_fft, n * hop - n_fft
    np.testing.assert_allclose(out[:, lo:hi], x[:, lo:hi], atol=2e-3)


@pytest.mark.parametrize("subbands", [2, 4])
def test_pqmf_filters_identical(subbands):
    for synthesis in (False, True):
        np.testing.assert_array_equal(
            ti.pqmf_filters(subbands, synthesis=synthesis),
            ji.pqmf_filters(subbands, synthesis=synthesis))


@pytest.mark.parametrize("subbands", [2, 4])
def test_pqmf_synthesis_matches_jax(subbands):
    bands = np.random.RandomState(subbands).randn(2, 40, subbands).astype(
        np.float32)
    filters = ji.pqmf_filters(subbands, synthesis=True)
    want = np.asarray(ji.pqmf_synthesis(jnp.asarray(bands), filters))
    for f in (filters, torch.as_tensor(filters)):
        got = ti.pqmf_synthesis(t(bands), f).numpy()
        assert got.shape == want.shape == (2, 40 * subbands)
        np.testing.assert_allclose(got, want, atol=FN_TOL, rtol=0)


def _jax_decoder(cfg):
    """The flax decoder VISinger builds for ``cfg``, and its port twin."""
    dil = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
    common = (cfg.resblock, tuple(cfg.resblock_kernel_sizes), dil)
    if cfg.decoder_type == "istft":
        return ji.ISTFTGenerator(
            *common, tuple(cfg.istft_upsample_rates),
            tuple(cfg.istft_upsample_kernel_sizes),
            cfg.upsample_initial_channel, cfg.istft_n_fft, cfg.istft_hop)
    return ji.MBISTFTGenerator(
        *common, tuple(cfg.mb_upsample_rates),
        tuple(cfg.mb_upsample_kernel_sizes), cfg.upsample_initial_channel,
        cfg.istft_n_fft, cfg.istft_hop, cfg.mb_subbands)


@pytest.fixture(scope="module", params=sorted(DECODERS))
def decoder_pair(request):
    """(config, flax decoder, params, port decoder, hidden input)."""
    jcfg = DECODERS[request.param]
    cfg = same_config(tv.SVSConfig, jcfg)
    hidden = np.random.RandomState(7).randn(
        2, 12, cfg.inter_channels).astype(np.float32)
    jdec = _jax_decoder(jcfg)
    params = init_params(jdec, 3, jnp.asarray(hidden))
    port = tv.VISinger(cfg).decoder
    port.load_state_dict(state_dict_from_flax(params, port))
    return cfg, jdec, params, port, hidden


def test_generator_matches_flax(decoder_pair):
    cfg, jdec, params, port, hidden = decoder_pair
    want = np.asarray(jax.jit(jdec.apply)(params, jnp.asarray(hidden)))
    with torch.no_grad():
        got = port(t(hidden)).numpy()
    assert got.shape == want.shape == (2, 12 * cfg.hop_length, 1)
    assert rel_err(got, want) <= FWD_TOL


def test_decoder_gradients_match_jax(decoder_pair):
    """d(sum(audio * r)) / d(decoder parameters), each tensor."""
    cfg, jdec, params, port, hidden = decoder_pair
    r = np.random.RandomState(8).randn(2, 12 * cfg.hop_length, 1).astype(
        np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        jdec.apply(p, jnp.asarray(hidden)) * r)))(params)
    names = dict(port.named_parameters())
    port.zero_grad()
    (port(t(hidden)) * t(r)).sum().backward()
    grads = {k: v.grad.numpy() for k, v in names.items()}
    jgrads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want),
                                  port)
    assert set(jgrads) == set(grads)
    errs = {k: rel_err(grads[k], jgrads[k].numpy()) for k in grads}
    assert max(errs.values()) <= GRAD_TOL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:3]


def _visinger_pair(jcfg, batch):
    """(jax model, params, port model) with the same random weights, the
    tree of the training __call__ (spec_encoder included)."""
    cfg = same_config(tv.SVSConfig, jcfg)
    jm = jv.VISinger(jcfg)
    params = init_params(jm, 5, *_gen_args(batch), deterministic=True)
    port = tv.VISinger(cfg)
    port.load_state_dict(visinger_state_dict_from_flax(params, cfg))
    assert any(k.startswith("decoder.istft_head") for k in
               port.state_dict())
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def batch():
    from music_generation_tpu.train import data as j_data
    return j_data.synthetic_batch(TINY_ISTFT, batch=2, t_phones=8,
                                  t_frames=32, seed=0)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_visinger_infer_and_forward_match_flax(decoder, batch):
    """VISinger.infer (pinned durations, injected prior noise) and the
    training forward (injected posterior, reverse-KL and slice draws),
    the audio and the decoder's input."""
    jcfg = DECODERS[decoder]
    jm, params, port = _visinger_pair(jcfg, batch)
    rng = np.random.RandomState(11)
    max_frames = 32
    noise = rng.randn(2, max_frames, jcfg.inter_channels).astype(np.float32)
    ph_dur = rng.randint(1, 4, (2, 8)).astype(np.int32)
    score = {k: batch[k] for k in ("phones", "x_lengths", "note_ids",
                                   "note_durations", "shengdiao")}
    audio_j, len_j, _ = jax.jit(lambda p: jm.apply(
        p, **score, max_frames=max_frames, noise=noise, ph_dur=ph_dur,
        method=jv.VISinger.infer))(params)
    with torch.no_grad():
        audio_t, len_t, _ = port.infer(
            t(score["phones"]), t(score["x_lengths"]), t(score["note_ids"]),
            t(score["note_durations"]), t(score["shengdiao"]), max_frames,
            noise=t(noise), ph_dur=t(ph_dur))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert rel_err(audio_t.numpy(), np.asarray(audio_j)) <= FWD_TOL

    rng = np.random.RandomState(12)
    shape = (2, 32, jcfg.inter_channels)
    draws = {"noise": rng.randn(*shape).astype(np.float32),
             "noise_rev": rng.randn(*shape).astype(np.float32),
             "slice_u": rng.uniform(0, 1, (2,)).astype(np.float32)}
    with jax_draws(draws):
        out_j = jax.jit(lambda p: jm.apply(
            p, *_gen_args(batch), deterministic=True,
            rngs={"noise": jax.random.PRNGKey(0),
                  "slice": jax.random.PRNGKey(1)}))(params)
    with torch.no_grad():
        out_t = port(*(t(a) for a in _gen_args(batch)), deterministic=True,
                     **{k: t(v) for k, v in draws.items()})
    np.testing.assert_array_equal(out_t["ids_slice"].numpy(),
                                  np.asarray(out_j["ids_slice"]))
    for key in ("audio", "spec_predict", "z_hat"):
        assert rel_err(out_t[key].numpy(), np.asarray(out_j[key])) \
            <= FWD_TOL, key


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_train_cli_trains_decoder(decoder, tmp_path):
    """python -m music_generation_tpu_torch.train --tiny --device cpu
    --steps 2 --decoder ...: two steps with MAS durations, finite losses,
    a step_2.pt whose generator holds the decoder's iSTFT head."""
    plain = maximum_path.plain_calls
    train_main(["--tiny", "--device", "cpu", "--steps", "2", "--decoder",
                decoder, "--durations", "mas", "--batch-size", "2",
                "--warmup-steps", "0", "--log-every", "1", "--ckpt-dir",
                str(tmp_path)])
    assert maximum_path.plain_calls == plain + 4
    ckpt = torch.load(tmp_path / "step_2.pt", weights_only=True)
    cfg = build_svs_config(tiny=True, decoder=decoder)
    assert cfg == same_config(tv.SVSConfig, DECODERS[decoder])
    head = ckpt["gen"]["decoder.istft_head.weight"]
    n_bins = cfg.istft_n_fft // 2 + 1
    assert head.shape[0] == 2 * n_bins * (cfg.mb_subbands if decoder ==
                                          "mb_istft" else 1)
    with open(tmp_path / "logs" / "train_metrics.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert len(rows) == 2 and all(np.isfinite(r["loss_gen"]) for r in rows)
    os.remove(tmp_path / "step_2.pt")  # 0.5 GB with the discriminator's


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_server_builds_decoder(decoder):
    """serve.app --tiny --device cpu --decoder ...: configure and
    build_songs (what main() serves) give every singer the decoder, and a
    song comes out as 22,050 Hz int16."""
    from scipy.io import wavfile
    args, cfg = t_app.configure(["--tiny", "--device", "cpu", "--decoder",
                                 decoder])
    songs = t_app.build_songs(args, cfg)
    want = ti.MBISTFTGenerator if decoder == "mb_istft" \
        else ti.ISTFTGenerator
    assert len(songs.synthesizers) == 3 and all(
        type(s.model.decoder) is want for s in songs.synthesizers.values())
    rate, wav = wavfile.read(io.BytesIO(
        songs.synthesize_song("你好世界").wav_bytes))
    assert rate == 22050 and wav.dtype == np.int16
    assert len(wav) > int(0.2 * 22050) and np.any(wav != 0)
