"""Trained weights into the port's server (CPU, tiny configs).

- compat.checkpoints: a port pipeline directory round trip, missing files
  skipped, the tolerant load's WARNING counts;
- tools/torch_import_pipeline.py --jax-dir: JAX orbax save_params trees of
  a tiny VISinger (as a JAX server holds it: no spec_encoder) and of the
  tiny MSE melody, converted and loaded with the port's load_pipeline;
- tools/torch_import_pipeline.py --pth and compat.torch_import: a
  synthetic reference SynthesizerTrn state_dict, built from random flax
  params by inverting the layouts;
- tools/torch_export_trained_svs.py: a port trainer step_<n>.pt to the
  served weights;
- serve.app's main() with --checkpoint-dir and a certificate (HTTPS),
  and MUSIC_BACKEND=new configuring the shell backend.
Tolerances: the waveform of VISinger.infer within 1e-4 relative L2 of the
JAX package's (tests/test_torch_svs.py), teacher-forced note log-probs and
MSE log-durations within 1e-5 (tests/test_torch_melody.py); copied
tensors equal.
"""

import base64
import dataclasses
import io
import json
import logging
import os
import re
import ssl
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.compat.checkpoints import save_params as j_save
from music_generation_tpu.compat.torch_import import (
    visinger_params_from_torch)
from music_generation_tpu.frontend import load_lexicon
from music_generation_tpu.models.melody import api as j_api
from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.models.melody.vocab import (
    lyric_dictionary_from_chars, note_dictionary)
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu_torch.compat import (load_params, load_pipeline,
                                               save_params, save_pipeline,
                                               sdp_state_dict_from_flax,
                                               visinger_state_dict_from_flax,
                                               visinger_state_dict_from_torch)
from music_generation_tpu_torch.models.melody import transformer as t_tr
from music_generation_tpu_torch.models.svs import VISinger
from music_generation_tpu_torch.pipeline.synthesis import (
    build_default_song_synthesizer, tiny_configs)
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.train import (TrainConfig, build_svs_config,
                                              save_checkpoint)
from music_generation_tpu_torch.train.trainer import Optimizer, TrainState
from torch_port_util import (F, _shapes_only_init, init_params,
                             random_params, rel_err, same_config, svs_score,
                             t, visinger_pair)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import torch_export_trained_svs  # noqa: E402
import torch_import_pipeline  # noqa: E402

WAVE_TOL = 1e-4
LOGP_TOL = 1e-5
SENTENCES = ["小小的天有大大的梦想", "隐形的翅膀"]


def _states_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def _songs(seed):
    return build_default_song_synthesizer(tiny=True, n_speakers=2,
                                          seed=seed, device="cpu")


def _models(songs):
    return [s.model for s in songs.synthesizers.values()] + [
        songs.melody.note_model, songs.melody.duration_model]


# ---- compat.checkpoints ---------------------------------------------------

def test_pipeline_round_trip(tmp_path):
    """save_pipeline, then load_pipeline into songs built from another
    seed: every tensor equal; a missing file leaves its model as built."""
    src, dst = _songs(0), _songs(1)
    save_pipeline(str(tmp_path), src)
    assert sorted(os.listdir(tmp_path)) == [
        "melody_duration.pt", "melody_notes.pt", "svs_0.pt", "svs_1.pt"]
    assert not any(_states_equal(a, b)
                   for a, b in zip(_models(src), _models(dst)))
    os.remove(tmp_path / "svs_1.pt")
    before = {k: v.clone() for k, v in
              dst.synthesizers[1].model.state_dict().items()}
    assert load_pipeline(str(tmp_path), dst) == [
        "svs_0.pt", "melody_notes.pt", "melody_duration.pt"]
    for a, b in zip(_models(src), _models(dst)):
        if b is not dst.synthesizers[1].model:
            assert _states_equal(a, b)
    after = dst.synthesizers[1].model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with pytest.raises(FileNotFoundError):
        load_pipeline(str(tmp_path / "absent"), dst)


def test_load_params_tolerant(tmp_path, caplog):
    """A shape mismatch keeps that tensor at init, an extra key is
    unused, the rest is restored; one WARNING line gives the counts. An
    exact match loads strictly, with no warning."""
    src = VISinger(tiny_configs(0)[1])
    dst = VISinger(tiny_configs(0)[1])
    path = str(tmp_path / "svs.pt")
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    sd["decoder.conv_pre.bias"] = torch.zeros(3)
    sd["spec_encoder.extra"] = torch.zeros(2)
    torch.save(sd, path)
    init_bias = dst.decoder.conv_pre.bias.detach().clone()
    with caplog.at_level(logging.WARNING, "music_generation_tpu_torch"):
        load_params(path, dst)
    n = len(src.state_dict())
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
    assert warnings == [f"tolerant restore from {path}: {n - 1} tensors "
                        f"restored, 1 kept at init, 2 in the file unused"]
    assert torch.equal(dst.decoder.conv_pre.bias, init_bias)
    assert torch.equal(dst.decoder.conv_post.weight,
                       src.decoder.conv_post.weight)
    caplog.clear()
    save_params(path, src)
    with caplog.at_level(logging.WARNING, "music_generation_tpu_torch"):
        load_params(path, dst)
    assert not caplog.records and _states_equal(src, dst)


# ---- JAX pipeline directory -> the port -----------------------------------

def _jax_melody(seed=0):
    """A tiny JAX MelodyGenerator over the full monosyllable charset (the
    lyric dictionary the port's server builds), numpy-seeded weights."""
    lyric = lyric_dictionary_from_chars(
        sorted(load_lexicon().monosyllable.keys()))
    jcfg = j_tr.MelodyConfig(src_vocab=lyric.size, tgt_vocab=37, n_layers=1,
                             d_model=32, d_ff=64, n_heads=2)
    with _shapes_only_init(j_tr.MelodyTransformer), \
            _shapes_only_init(j_tr.MSEDurationModel):
        jgen = j_api.MelodyGenerator(lyric, note_dictionary(), cfg=jcfg)
    jgen.note_params = random_params(jgen.note_params, seed)
    jgen.duration_params = random_params(jgen.duration_params, seed + 1)
    return jgen


@pytest.fixture(scope="module")
def jax_infer():
    """One jitted JAX VISinger.infer over the served tree (no
    spec_encoder), shared by the tests that compare waveforms."""
    jm = jv.VISinger(same_config(jv.SVSConfig, tiny_configs(0)[1]))
    score = svs_score()
    rng = np.random.RandomState(1)
    noise = rng.randn(2, F, 16).astype(np.float32)
    ph_dur = rng.randint(1, 6, (2, 16)).astype(np.int32)
    fn = jax.jit(lambda p: jm.apply(p, **score, max_frames=F, noise=noise,
                                    ph_dur=ph_dur,
                                    method=jv.VISinger.infer))

    def compare(params, port):
        audio_j, len_j, _ = fn({"params": {
            k: v for k, v in params["params"].items()
            if k != "spec_encoder"}})
        with torch.no_grad():
            audio_t, len_t, _ = port.infer(
                *(t(score[k]) for k in ("phones", "x_lengths", "note_ids",
                                        "note_durations", "shengdiao")),
                F, noise=t(noise), ph_dur=t(ph_dur))
        np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
        return rel_err(audio_t.numpy(), np.asarray(audio_j))
    return compare


def test_jax_pipeline_dir_served(tmp_path, jax_infer, caplog, capsys):
    """JAX save_params trees -> torch_import_pipeline --jax-dir ->
    load_pipeline: VISinger.infer and the melody's note log-probs and
    log-durations match the JAX package's. The same HiFi-GAN tree
    converted for --decoder istft exits 2 naming the leaves the iSTFT
    model has no place for."""
    _, params, _ = visinger_pair(seed=3)
    served = {"params": {k: v for k, v in params["params"].items()
                         if k != "spec_encoder"}}
    jgen = _jax_melody()
    jax_dir, out = tmp_path / "jax", tmp_path / "port"
    j_save(str(jax_dir / "svs_0"), served)
    j_save(str(jax_dir / "melody_notes"), jgen.note_params)
    j_save(str(jax_dir / "melody_duration"), jgen.duration_params)
    torch_import_pipeline.main(["--jax-dir", str(jax_dir), "--out",
                                str(out), "--tiny"])
    assert sorted(os.listdir(out)) == ["melody_duration.pt",
                                       "melody_notes.pt", "svs_0.pt"]
    songs = _songs(7)
    with caplog.at_level(logging.WARNING, "music_generation_tpu_torch"):
        load_pipeline(str(out), songs)
    # the served tree has no spec_encoder: those tensors stay at init
    n_enc = sum(k.startswith("spec_encoder.") for k in
                songs.synthesizers[0].model.state_dict())
    assert [r.getMessage() for r in caplog.records] == [
        f"tolerant restore from {out / 'svs_0.pt'}: "
        f"{len(songs.synthesizers[0].model.state_dict()) - n_enc} tensors "
        f"restored, {n_enc} kept at init, 0 in the file unused"]
    assert jax_infer(params, songs.synthesizers[0].model) <= WAVE_TOL

    melody = songs.melody
    src = np.concatenate([jgen._encode_src(s) for s in SENTENCES])
    np.testing.assert_array_equal(
        src, np.concatenate([melody._encode_src(s) for s in SENTENCES]))
    tgt = np.random.RandomState(3).randint(4, 37, (2, 14)).astype(np.int32)
    src_mask = (src != 0)[:, None, None, :].astype(np.int32)
    want = jax.jit(jgen.note_model.apply)(jgen.note_params, src, tgt,
                                          src_mask, j_tr.causal_mask(14))
    want_dur = jax.jit(jgen.duration_model.apply)(jgen.duration_params, src,
                                                  src_mask)
    with torch.no_grad():
        got = melody.note_model(t(src).long(), t(tgt).long(), t(src_mask),
                                t_tr.causal_mask(14))
        got_dur = melody.duration_model(t(src).long(), t(src_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGP_TOL, rtol=0)
    np.testing.assert_allclose(got_dur.numpy(), np.asarray(want_dur),
                               atol=LOGP_TOL, rtol=0)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        torch_import_pipeline.main(["--jax-dir", str(jax_dir), "--out",
                                    str(tmp_path / "istft"), "--tiny",
                                    "--decoder", "istft"])
    assert e.value.code == 2
    assert "unconsumed leaves" in capsys.readouterr().err


def test_jax_pipeline_dir_sdp_durations(tmp_path, caplog):
    """--variant svs_v5: the JAX SDP duration tree (as the JAX
    MelodyGenerator holds it) converts through sdp_state_dict_from_flax
    and loads strictly into the port's SDP melody, tensor for tensor."""
    lyric = lyric_dictionary_from_chars(
        sorted(load_lexicon().monosyllable.keys()))
    jcfg = j_tr.MelodyConfig(src_vocab=lyric.size, tgt_vocab=37, n_layers=1,
                             d_model=32, d_ff=64, n_heads=2)
    with _shapes_only_init(j_tr.MelodyTransformer), \
            _shapes_only_init(j_tr.SDPDurationModel):
        jgen = j_api.MelodyGenerator(lyric, note_dictionary(), cfg=jcfg,
                                     duration_variant="sdp")
    params = random_params(jgen.duration_params, 2)
    j_save(str(tmp_path / "jax" / "melody_duration"), params)
    torch_import_pipeline.main(["--jax-dir", str(tmp_path / "jax"), "--out",
                                str(tmp_path / "port"), "--tiny",
                                "--variant", "svs_v5"])
    args, cfg = t_app.configure(["--tiny", "--device", "cpu", "--variant",
                                 "svs_v5"])
    cfg.n_speakers = 1
    songs = t_app.build_songs(args, cfg)
    melody = songs.melody
    with caplog.at_level(logging.WARNING, "music_generation_tpu_torch"):
        assert load_pipeline(str(tmp_path / "port"), songs) == [
            "melody_duration.pt"]
    assert not caplog.records
    want = sdp_state_dict_from_flax(params, melody.sdp_cfg)
    got = melody.duration_model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---- the reference's .pth -------------------------------------------------

_WN_CONVT = re.compile(r"^decoder/up_(\d+)$")
_RULES = [  # flax module path -> reference module path, in order
    (r"^text_encoder/emb_shengdiao$", "text_encoder.emb_phone_shengdiao"),
    (r"/attn_(\d+)/(q|k|v)$", r".attn_layers.\1.conv_\2"),
    (r"/attn_(\d+)/out$", r".attn_layers.\1.conv_o"),
    (r"/attn_(\d+)$", r".attn_layers.\1"),
    (r"/norm(1|2)_(\d+)$", r".norm_layers_\1.\2"),
    (r"/ffn_(\d+)/Conv1d_0$", r".ffn_layers.\1.conv_1"),
    (r"/ffn_(\d+)/Conv1d_1$", r".ffn_layers.\1.conv_2"),
    (r"^duration_predictor/(conv|norm)_(\d+)$", None),
    (r"/(f0_predictor|mel_predict_net)/out$", r"/\1.output_layer"),
    (r"/frame_prior_net/conv_(\d+)$", r".frame_prior_net.conv_layers.\1"),
    (r"/in_(\d+)$", r".in_layers.\1"),
    (r"/res_skip_(\d+)$", r".res_skip_layers.\1"),
    (r"^spec_flow/coupling_(\d+)", None),
    (r"^decoder/up_(\d+)$", r"decoder.ups.\1"),
    (r"^decoder/res_(\d+)_(\d+)", None),
    (r"/conv(1|2)_(\d+)$", r".convs\1.\2"),
]


def _reference_name(path: str, n_k: int) -> str:
    """A flax module path ('text_encoder/encoder/attn_0/q') -> the
    reference SynthesizerTrn's ('text_encoder.encoder.attn_layers.0.
    conv_q')."""
    for pat, rep in _RULES:
        m = re.search(pat, path)
        if not m:
            continue
        if pat.startswith("^duration_predictor"):
            rep = f"duration_predictor.{m.group(1)}_{int(m.group(2)) + 1}"
        elif pat.startswith("^spec_flow"):
            rep = f"spec_flow.spec_flows.{2 * int(m.group(1))}"
        elif pat.startswith("^decoder/res_"):
            rep = (f"decoder.resblocks."
                   f"{int(m.group(1)) * n_k + int(m.group(2))}")
        path = path[:m.start()] + m.expand(rep) + path[m.end():]
    return path.replace("/", ".")


def reference_state_dict(params: dict, n_k: int) -> tuple[dict, dict]:
    """(reference-named torch state_dict, the flax tree it stands for)
    from a flax VISinger tree. Weight-normed convs (a "g" leaf) become
    (weight_g, weight_v) with the effective weight in v, and the flax tree
    is made canonical to match (kernel = w_eff, g = ||w_eff||), the form
    visinger_params_from_torch produces; conv kernels [k, in, out] ->
    [out, in, k], transposed-conv kernels -> [in, out, k] unflipped, dense
    [in, out] -> [out, in], LayerNorm scale/bias -> gamma/beta."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                params["params"])[0]}
    modules = sorted({p.rpartition("/")[0] for p in flat})
    sd, canon = {}, {}
    for mod in modules:
        leaves = {p.rpartition("/")[2]: v for p, v in flat.items()
                  if p.rpartition("/")[0] == mod}
        ref = _reference_name(mod.replace("/LayerNorm_0", ""), n_k)
        for leaf, v in leaves.items():
            canon[f"{mod}/{leaf}"] = v
        if "g" in leaves:
            k = leaves["kernel"]
            norm = np.linalg.norm(k.reshape(-1, k.shape[-1]), axis=0)
            w = (k * leaves["g"] / norm).astype(np.float32)
            canon[f"{mod}/kernel"] = w
            canon[f"{mod}/g"] = np.linalg.norm(w.reshape(-1, w.shape[-1]),
                                               axis=0)
            v = (np.transpose(w[::-1], (1, 2, 0)) if _WN_CONVT.match(mod)
                 else np.transpose(w, (2, 1, 0)))
            sd[f"{ref}.weight_v"] = v
            sd[f"{ref}.weight_g"] = np.sqrt(
                (v.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)
            ).astype(np.float32)
        elif "kernel" in leaves:
            k = leaves["kernel"]
            sd[f"{ref}.weight"] = k.T if k.ndim == 2 else \
                np.transpose(k, (2, 1, 0))
        elif "scale" in leaves:
            sd[f"{ref}.gamma"] = leaves["scale"]
            sd[f"{ref}.beta"] = leaves["bias"]
            continue
        elif "embedding" in leaves:
            sd[f"{ref}.weight"] = leaves["embedding"]
        for leaf in ("bias", "emb_rel_k", "emb_rel_v"):
            if leaf in leaves:
                sd[f"{ref}.{leaf}"] = leaves[leaf]
    tree: dict = {}
    for path, v in canon.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return ({k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in sd.items()}, {"params": tree})


def _flax_visinger(cfg, seed):
    """A numpy-seeded flax VISinger tree for the port config ``cfg``,
    spec_encoder included (visinger_pair's tree)."""
    jcfg = same_config(jv.SVSConfig, cfg)
    params = init_params(jv.VISinger(jcfg), seed, **svs_score(),
                         max_frames=F, method=jv.VISinger.infer)
    params["params"]["spec_encoder"] = init_params(
        jv.PosteriorEncoder(jcfg), seed + 1,
        jnp.zeros((1, 8, cfg.spec_channels)), jnp.ones((1, 8, 1)))["params"]
    return params


def test_reference_import_matches_jax():
    """The synthetic reference state_dict: the JAX package's
    visinger_params_from_torch gives back the canonical flax tree (which
    checks the helper), and the port's import equals
    visinger_state_dict_from_flax of that tree tensor for tensor, raw or
    in the reference trainer's {"model": ...} wrapper. (The JAX table
    takes the reference's three convs per ResBlock1, so this config has
    three dilations.)"""
    cfg = dataclasses.replace(tiny_configs(0)[1],
                              resblock_dilation_sizes=((1, 3, 5),))
    sd, canon = reference_state_dict(_flax_visinger(cfg, 4),
                                     len(cfg.resblock_kernel_sizes))
    jtree = visinger_params_from_torch(sd, same_config(jv.SVSConfig, cfg))
    want_flat = jax.tree_util.tree_flatten_with_path(canon)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert set(got_flat) == {p for p, _ in want_flat}
    for path, v in want_flat:
        np.testing.assert_allclose(got_flat[path], v, rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    want = visinger_state_dict_from_flax(jtree, cfg)
    for blob in (sd, {"model": sd, "iteration": 7}):
        got = visinger_state_dict_from_torch(blob, cfg)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="non-AE"):
        visinger_state_dict_from_torch(
            {k: v for k, v in sd.items()
             if not k.startswith("spec_decoder.")}, cfg)


def test_reference_pth_served(tmp_path, jax_infer):
    """A reference .pth of the tiny served config through
    torch_import_pipeline --pth and load_pipeline: every tensor restored,
    and VISinger.infer matches the JAX package's on the flax tree the file
    stands for."""
    cfg = tiny_configs(0)[1]
    sd, canon = reference_state_dict(_flax_visinger(cfg, 6),
                                     len(cfg.resblock_kernel_sizes))
    pth = tmp_path / "G_AE.pth"
    torch.save({"model": sd, "iteration": 7, "learning_rate": 2e-4}, pth)
    torch_import_pipeline.main(["--pth", str(pth), "--out",
                                str(tmp_path / "port"), "--tiny"])
    songs = _songs(8)
    assert load_pipeline(str(tmp_path / "port"), songs) == ["svs_0.pt"]
    model = songs.synthesizers[0].model
    want = visinger_state_dict_from_flax(canon, cfg)
    assert want.keys() == model.state_dict().keys()
    assert jax_infer(canon, model) <= WAVE_TOL


# ---- the port trainer's checkpoint -> the server --------------------------

def test_export_trained_svs(tmp_path, capsys):
    """A port trainer step_<n>.pt through torch_export_trained_svs: each
    svs_<id>.pt holds the generator's tensors, equal; another --decoder
    exits 2."""
    cfg, tc = build_svs_config(tiny=True), TrainConfig()
    gen = VISinger(cfg)
    with torch.no_grad():  # stand-in for training: off the init
        for p in gen.parameters():
            p.add_(0.01)
    # a small stand-in discriminator: the export reads the generator only
    disc = torch.nn.Linear(2, 2)
    gen_state = TrainState(gen, Optimizer(gen.parameters(), tc))
    disc_state = TrainState(disc, Optimizer(disc.parameters(), tc))
    ckpt = save_checkpoint(str(tmp_path / "ck"), gen_state, disc_state, 3)
    out = tmp_path / "served"
    torch_export_trained_svs.main(["--ckpt", ckpt, "--out", str(out),
                                   "--tiny", "--speakers", "0", "2"])
    assert sorted(os.listdir(out)) == ["svs_0.pt", "svs_2.pt"]
    for sid in (0, 2):
        model = VISinger(cfg)
        load_params(str(out / f"svs_{sid}.pt"), model)
        assert _states_equal(model, gen_state.model)
    with pytest.raises(SystemExit) as e:
        torch_export_trained_svs.main(["--ckpt", ckpt, "--out", str(out),
                                       "--tiny", "--decoder", "mb_istft"])
    assert e.value.code == 2 and "does not match" in capsys.readouterr().err


def _https_post(port, payload):
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    req = urllib.request.Request(
        f"https://127.0.0.1:{port}/synthesis_music",
        data=json.dumps(payload, ensure_ascii=False).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300, context=ctx) as r:
        return json.loads(r.read())


def _serve_main(argv, monkeypatch):
    """serve.app.main(argv) with its server bound to a free local port,
    one HTTPS text request, then shut down: (answer, service)."""
    make_server, seen = t_app.make_http_server, []

    def free_port_server(service, host, port, **tls):
        assert tls["cert_file"], tls
        srv = make_server(service, "127.0.0.1", 0, **tls)

        def request():
            try:
                seen.append(_https_post(srv.server_address[1],
                                        {"text": "你好世界"}))
            finally:
                srv.shutdown()
        seen.append(service)
        threading.Thread(target=request, daemon=True).start()
        return srv

    monkeypatch.setattr(t_app, "make_http_server", free_port_server)
    t_app.main(argv)
    service, out = seen
    assert out["code"] == 200, out
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16
    return service


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    """A pipeline directory of tiny songs from seed 5, and the songs."""
    d = tmp_path_factory.mktemp("served")
    songs = _songs(5)
    save_pipeline(str(d), songs)
    return d, songs


def _self_signed(tmp_path, split: bool):
    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem" if split else cert
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", str(key), "-out", str(cert),
                    "-days", "1", "-subj", "/CN=localhost"],
                   check=True, capture_output=True)
    return cert, key


@pytest.mark.parametrize("source", ["flags", "config"])
def test_served_checkpoint_over_https(source, served_dir, tmp_path,
                                      monkeypatch):
    """main() serves the checkpoint dir's weights over HTTPS: from
    --checkpoint-dir, --cert-file and --key-file, or from the --config
    file's checkpoint_dir and cert_file_path (key appended to the
    certificate)."""
    d, songs = served_dir
    monkeypatch.chdir(tmp_path)
    cert, key = _self_signed(tmp_path, split=source == "flags")
    argv = ["--tiny", "--device", "cpu"]
    if source == "flags":
        argv += ["--checkpoint-dir", str(d), "--cert-file", str(cert),
                 "--key-file", str(key)]
    else:
        (tmp_path / "cfg.json").write_text(json.dumps(
            {"checkpoint_dir": str(d), "cert_file_path": str(cert),
             "log_dir": str(tmp_path / "logs")}))
        argv += ["--config", str(tmp_path / "cfg.json")]
    service = _serve_main(argv, monkeypatch)
    served = service.songs
    assert service.cfg.cert_file_path == str(cert)
    for sid, svs in songs.synthesizers.items():
        assert _states_equal(served.synthesizers[sid].model, svs.model)
    assert _states_equal(served.melody.note_model, songs.melody.note_model)


def test_shell_backend_refused(monkeypatch, capsys):
    """MUSIC_BACKEND=new selects the shell backend, which is no longer
    refused: configure() sets it and main()'s service is built around it
    (served end to end: tests/test_torch_shell_pipeline.py)."""
    monkeypatch.setenv("MUSIC_BACKEND", "new")
    args, cfg = t_app.configure(["--tiny", "--device", "cpu"])
    assert cfg.backend == "shell" and args.variant == "svs_v6_multispeaker"
    assert "shell backend" not in capsys.readouterr().err
    monkeypatch.setenv("MUSIC_BACKEND", "old")
    assert t_app.configure(["--tiny", "--device", "cpu"])[1].backend == \
        "model"
