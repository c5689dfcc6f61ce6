"""SDP melody variant (svs_v5) and the variant presets: PyTorch port vs JAX.

Splines, DDSConv, the SDP flows, SDPDurationModel.infer_duration and the
SDP MelodyGenerator's durations against their flax twins at tiny widths,
numpy-seeded weights carried across with compat.from_jax. The JAX side's
flow noise is injected with monkeypatch on jax.random.normal (this test
only); the port takes the same noise as an argument. Tolerances: 1e-5
(float32 sums in another order); the spline's log-determinant within
1e-5 + twice JAX's own float32 error of the float64 value; the port's
spline inverse of its forward within 1e-4; formatted durations, sentence
splits and the variant table identical. Also the port's HTTP service under tiny svs_v5_multispeaker,
melody_v2 and v1_model, and the variant it refuses.
"""

import base64
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.core import flows as j_flows
from music_generation_tpu.core import layers as j_layers
from music_generation_tpu.core import splines as j_spl
from music_generation_tpu.models.melody import api as j_api
from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.models.melody.vocab import (
    lyric_dictionary_from_chars, note_dictionary)
from music_generation_tpu.pipeline import synthesis as j_syn
from music_generation_tpu.serve import variants as j_var
from music_generation_tpu_torch.compat import (sdp_state_dict_from_flax,
                                               state_dict_from_flax)
from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.core import flows as t_flows
from music_generation_tpu_torch.core import layers as t_layers
from music_generation_tpu_torch.core import splines as t_spl
from music_generation_tpu_torch.models.melody import api as t_api
from music_generation_tpu_torch.models.melody import transformer as t_tr
from music_generation_tpu_torch.pipeline import synthesis as t_syn
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.serve import variants as t_var
from torch_port_util import (_shapes_only_init, init_params, random_params,
                             same_config, t, tiny_songs)

TOL = 1e-5
B, T, C = 2, 12, 8
LENGTHS = np.array([12, 7])
SENTENCES = ["小小的天有大大的梦想", "隐形的翅膀", "带我飞过绝望"]
LYRIC = lyric_dictionary_from_chars("".join(SENTENCES))
# the SDP tests share one config and one [3, 60] source shape, so JAX's
# eager apply compiles each primitive once for all of them
SDP_CFG = j_tr.SDPDurationConfig(src_vocab=LYRIC.size, hidden_dim=16,
                                 n_layers=1, n_heads=2, pf_dim=32, max_len=60)


def _mask():
    return (np.arange(T)[None, :] < LENGTHS[:, None]).astype(
        np.float32)[..., None]


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params, module))
    return module.eval()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---- splines ---------------------------------------------------------------

def _spline_case(inverse: bool):
    """Inputs inside the bound, on both tails (|x| > 5, and exactly +-5)
    and on each spline's own knots, with unit-scale spline parameters."""
    rng = np.random.RandomState(1)
    shape = (3, 20, 2)
    uw, uh = (rng.randn(*shape, 10).astype(np.float32) for _ in range(2))
    ud = rng.randn(*shape, 9).astype(np.float32)
    x = rng.uniform(-4.9, 4.9, shape).astype(np.float32)
    x[0, :6] = np.array([-7.0, -5.5, -5.0, 5.0, 5.5, 7.0])[:, None]
    knots, _ = t_spl._knots(t(uh if inverse else uw), -5.0, 5.0, 1e-3)
    row = np.arange(shape[1])
    x[1] = knots.numpy()[1, row, :, row % 11]  # knot j % 11 of spline j
    return x, uw, uh, ud


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_spline_matches_jax(inverse):
    """Outputs within 1e-5 of JAX. The log-determinant subtracts two logs
    that float32 rounds apart where a bin is narrow, so JAX's own float32
    value can lie more than 1e-5 from its float64 one: the port's must lie
    within 1e-5 + twice that distance of the float64 value."""
    x, uw, uh, ud = _spline_case(inverse)

    def jax_spline(dtype):
        return j_spl.piecewise_rational_quadratic_transform(
            *(jnp.asarray(a, dtype) for a in (x, uw, uh, ud)),
            inverse=inverse, tails="linear", tail_bound=5.0)
    want_y, want_ld = (np.asarray(a) for a in jax_spline(jnp.float32))
    with jax.enable_x64(True):
        exact_ld = np.asarray(jax_spline(jnp.float64)[1])
    got_y, got_ld = t_spl.unconstrained_rational_quadratic_spline(
        t(x), t(uw), t(uh), t(ud), inverse=inverse, tail_bound=5.0)
    _close(got_y, want_y)
    jax_err = np.abs(want_ld - exact_ld)
    port_err = np.abs(got_ld.numpy() - exact_ld)
    assert (port_err <= TOL + 2 * jax_err).all(), \
        (port_err.max(), jax_err.max())
    outside = np.abs(x) > 5.0
    assert outside.any()
    np.testing.assert_array_equal(got_y.numpy()[outside], x[outside])
    np.testing.assert_array_equal(got_ld.numpy()[outside], 0.0)


def test_spline_inverse_of_forward():
    x, uw, uh, ud = _spline_case(False)
    y, ld = t_spl.unconstrained_rational_quadratic_spline(
        t(x), t(uw), t(uh), t(ud))
    back, ld_inv = t_spl.unconstrained_rational_quadratic_spline(
        y, t(uw), t(uh), t(ud), inverse=True)
    _close(back, x, 1e-4)
    _close(ld_inv, -ld, 1e-4)


# ---- DDSConv and the SDP flows ---------------------------------------------

def test_ddsconv_matches_jax():
    rng = np.random.RandomState(2)
    x, g = (rng.randn(B, T, C).astype(np.float32) for _ in range(2))
    jm = j_layers.DDSConv(kernel_size=3, n_layers=3)
    params = init_params(jm, 3, x, _mask(), g=g)
    want = jm.apply(params, x, _mask(), g=g)
    port = _port(t_layers.DDSConv(C, 3, 3), params)
    with torch.no_grad():
        _close(port(t(x), t(_mask()), g=t(g)), want)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_convflow_matches_jax(reverse):
    rng = np.random.RandomState(4)
    x = (2.5 * rng.randn(B, T, 2)).astype(np.float32)  # some past +-5
    g = rng.randn(B, T, C).astype(np.float32)
    jm = j_flows.ConvFlow(2, C, 3, n_layers=3)
    params = init_params(jm, 5, x, _mask(), g=g, reverse=reverse)
    want = jm.apply(params, x, _mask(), g=g, reverse=reverse)
    port = _port(t_flows.ConvFlow(2, C, 3, n_layers=3), params)
    with torch.no_grad():
        got = port(t(x), t(_mask()), g=t(g), reverse=reverse)
    if reverse:
        _close(got, want)
    else:
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("flow", ["affine", "log"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_affine_and_log_flows_match_jax(flow, reverse):
    rng = np.random.RandomState(6)
    x = rng.randn(B, T, 2).astype(np.float32)
    if flow == "log" and not reverse:
        x = np.abs(x)
        x[0, :3] = 0.0  # clamped to 1e-5
    if flow == "affine":
        jm, port = j_flows.ElementwiseAffine(2), t_flows.ElementwiseAffine(2)
        params = init_params(jm, 7, x, _mask())
        port = _port(port, params)
    else:
        jm, port, params = j_flows.LogFlow(), t_flows.LogFlow(), {}
    want = jm.apply(params, x, _mask(), reverse=reverse)
    with torch.no_grad():
        got = port(t(x), t(_mask()), reverse=reverse)
    if reverse:
        _close(got, want)
    else:
        _close(got[0], want[0])
        _close(got[1], want[1])


# ---- SDPDurationModel and the SDP MelodyGenerator ---------------------------

def _src(seed=8):
    rng = np.random.RandomState(seed)
    src = np.zeros((3, 60), np.int32)
    for i, length in enumerate((14, 9, 11)):
        src[i, :length] = rng.randint(1, SDP_CFG.src_vocab, length)
    return src


@pytest.fixture(scope="module")
def sdp_pair():
    jm = j_tr.SDPDurationModel(SDP_CFG)
    params = init_params(jm, 9, _src(), method=j_tr.SDPDurationModel
                         .infer_duration)
    cfg = same_config(t_tr.SDPDurationConfig, SDP_CFG)
    port = t_tr.SDPDurationModel(cfg)
    port.load_state_dict(sdp_state_dict_from_flax(params, cfg))
    return jm, params, port.eval()


def _inject(monkeypatch, noise):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(noise))


@pytest.mark.parametrize("noise_scale", [0.0, 0.8], ids=["no_noise",
                                                         "injected"])
def test_sdp_infer_duration_matches_jax(sdp_pair, monkeypatch, noise_scale):
    jm, params, port = sdp_pair
    src = _src()
    noise = np.random.RandomState(10).randn(*src.shape, 2).astype(np.float32)
    _inject(monkeypatch, noise)
    want = jm.apply(params, src, noise_scale=noise_scale,
                    method=j_tr.SDPDurationModel.infer_duration,
                    rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = port.infer_duration(t(src).long(), noise_scale=noise_scale,
                                  noise=t(noise))
    assert np.asarray(want)[0, :14].std() > 0
    _close(got, want)


def test_sdp_mapper_drops_only_training_subtrees(sdp_pair):
    """The tree of the JAX training __call__ also holds dp/flow_0 and the
    posterior; the mapper gives the same state_dict from it."""
    jm, params, _ = sdp_pair
    full = jax.eval_shape(lambda: jm.init(
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(("params", "noise", "dropout"))}, _src(),
        jnp.ones((3, 60))))
    full = random_params(full, 11)
    assert "flow_0" in full["params"]["dp"]
    assert "post_flow_0" in full["params"]["dp"]
    for path in (("encoder",), ("dp", "flow_1"), ("dp", "ea")):
        src, dst = params["params"], full["params"]
        for k in path[:-1]:
            src, dst = src[k], dst[k]
        dst[path[-1]] = src[path[-1]]
    cfg = same_config(t_tr.SDPDurationConfig, SDP_CFG)
    a = sdp_state_dict_from_flax(params, cfg)
    b = sdp_state_dict_from_flax(full, cfg)
    assert a.keys() == b.keys()
    for k in a:
        if k.startswith(("encoder.", "dp.flow.1.", "dp.ea.")):
            assert torch.equal(a[k], b[k]), k


def test_sdp_melody_generator_durations(monkeypatch):
    notes = note_dictionary()
    jcfg = j_tr.MelodyConfig(src_vocab=LYRIC.size, tgt_vocab=notes.size,
                             n_layers=1, d_model=32, d_ff=64, n_heads=2)
    with _shapes_only_init(j_tr.MelodyTransformer), \
            _shapes_only_init(j_tr.SDPDurationModel):
        jgen = j_api.MelodyGenerator(LYRIC, notes, cfg=jcfg,
                                     duration_variant="sdp",
                                     sdp_cfg=SDP_CFG)
    params = random_params(jgen.duration_params, 12)
    # log-durations spread around log(0.5 s): all three handle_durations
    # branches are taken
    params["params"]["dp"]["ea"]["m"][:] = [-2.0, 0.0]
    params["params"]["dp"]["ea"]["logs"][:] = [-0.5, 0.0]
    tgen = t_api.MelodyGenerator(
        LYRIC, notes, cfg=same_config(t_tr.MelodyConfig, jcfg),
        duration_variant="sdp",
        sdp_cfg=same_config(t_tr.SDPDurationConfig, SDP_CFG), device="cpu")
    tgen.duration_model.load_state_dict(
        sdp_state_dict_from_flax(params, tgen.sdp_cfg))
    src = np.concatenate([jgen._encode_src(s) for s in SENTENCES])
    noise = np.random.RandomState(13).randn(*src.shape, 2).astype(np.float32)
    _inject(monkeypatch, noise)
    want = np.asarray(jgen._duration_impl(params, jnp.asarray(src),
                                          jax.random.PRNGKey(0)))
    got = tgen.note_durations(t(src).long(), noise=t(noise)).numpy()
    _close(got, want)
    formatted = []
    for i, s in enumerate(SENTENCES):
        mine = tgen._format_durations(want[i], src[i], len(s))
        assert mine == jgen._format_durations(want[i], src[i], len(s))
        formatted += mine
    assert {0.3201, 0.4305} <= set(formatted)  # both clamps taken
    assert any(0.15 < d < 2 for d in formatted)


# ---- pipeline and variant presets ------------------------------------------

@pytest.mark.parametrize("lyrics", [
    "我要飞向远方去飞翔，换你的梦",
    "换你的梦。小小的天有大大的梦想，飞向远方去飞翔啊",
    "你,好。世界"])
def test_split_sentences_with_replacements(lyrics):
    for repl in ((), t_syn.LYRIC_REPLACEMENTS):
        assert t_syn.split_sentences(lyrics, replacements=repl) == \
            j_syn.split_sentences(lyrics, replacements=repl)
    assert t_syn.LYRIC_REPLACEMENTS == j_syn.LYRIC_REPLACEMENTS


def test_variant_table_and_canned_response(tmp_path):
    assert t_var.VARIANTS == {k: t_var.VariantSpec(**v.__dict__)
                              for k, v in j_var.VARIANTS.items()}
    assert t_var.canned_response("宁夏", None) is None
    assert t_var.canned_response("宁夏", str(tmp_path)) is None
    (tmp_path / "宁夏.txt").write_text("宁静的夏天", encoding="utf-8")
    (tmp_path / "宁夏.wav").write_bytes(b"RIFFfake")
    for kw in ("宁夏", " 宁夏 ", "别的"):
        assert t_var.canned_response(kw, str(tmp_path)) == \
            j_var.canned_response(kw, str(tmp_path))
    assert t_var.canned_response("宁夏", str(tmp_path))["data"]["lyrics"] \
        == "宁静的夏天"


@pytest.mark.parametrize("variant,missing", [("v1", "shell backend")])
def test_unported_variants_exit_at_startup(variant, missing, capsys):
    """No variant exits at startup any more: v1, the last one refused (for
    its shell backend), configures that backend in front of its model
    path, whose melody generator builds (served:
    tests/test_torch_shell_pipeline.py)."""
    args, cfg = t_app.configure(["--variant", variant, "--tiny", "--device",
                                 "cpu"])
    assert t_var.VARIANTS[variant].backend == "shell" == cfg.backend
    assert missing not in capsys.readouterr().err
    melody = t_var.build_melody_generator(t_var.VARIANTS[variant], tiny=True,
                                          device="cpu")
    assert melody.duration_variant == "mse"


def test_variant_server_refuses_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_app.main(["--variant", "melody_v2", "--tiny"])


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesis_music",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("variant", ["svs_v5_multispeaker", "melody_v2",
                                     "v1_model"])
def test_variant_served(variant, tmp_path, monkeypatch):
    """serve.app's main() itself with --tiny --device cpu --variant, its
    server bound to a free local port: a text request answers 200 with a
    WAV; under melody_v2 a canned keyword answers with the files in
    ./resources, which no other variant reads."""
    spec = t_var.VARIANTS[variant]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "resources").mkdir()
    (tmp_path / "resources" / "宁夏.txt").write_text("宁静的夏天",
                                                  encoding="utf-8")
    (tmp_path / "resources" / "宁夏.wav").write_bytes(b"RIFFfake")
    make_server, answers, servers = t_app.make_http_server, [], []

    def requests(srv):
        try:
            port = srv.server_address[1]
            answers.append(_post(port, {"text": "飞向远方去飞翔"}))
            if spec.canned_dir:
                answers.append(_post(port, {"keyword": "宁夏"}))
        finally:
            srv.shutdown()

    def free_port_server(service, host, port, **tls):
        srv = make_server(service, "127.0.0.1", 0, **tls)
        servers.append((srv, service))
        threading.Thread(target=requests, args=(srv,), daemon=True).start()
        return srv

    monkeypatch.setattr(t_app, "make_http_server", free_port_server)
    t_app.main(["--variant", variant, "--tiny", "--device", "cpu"])
    assert len(servers) == 1, servers
    assert len(answers) == 1 + bool(spec.canned_dir), answers
    out = answers[0]
    assert out["code"] == 200, out
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16
    assert len(wav) > int(0.2 * 22050)
    service = servers[0][1]
    songs = service.songs
    assert service.canned_dir == spec.canned_dir
    assert sorted(songs.synthesizers) == [0, 1, 2]
    assert songs.lyric_replacements == (t_syn.LYRIC_REPLACEMENTS
                                        if spec.censor_lyrics else ())
    assert songs.mix_accompaniment == spec.accompaniment
    if spec.melody == "sdp":
        assert songs.melody.duration_variant == "sdp"
    elif spec.melody == "telemelody":
        assert isinstance(songs.melody, t_var._TeleMelodyAdapter)
    else:
        assert isinstance(songs.melody, t_var._Seq2SeqAdapter)
    if spec.canned_dir:
        assert answers[1]["code"] == 200
        assert answers[1]["data"]["lyrics"] == "宁静的夏天"
