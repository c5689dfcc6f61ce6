"""The whole served slice on the CPU: PyTorch port vs JAX stages by hand.

JAX side: MelodyGenerator.generate_song -> ScoreFrontend.align ->
SVSSynthesizer._batch_inputs -> VISinger.infer(noise=N) -> the same
on-device int16 normalisation -> concat_with_delay. Port side: its
SongSynthesizer given the same N. Same numpy-seeded tiny weights on both.
Expected: equal notes, equal sample counts, int16 samples within +-4 LSB.
Also the port's HTTP service round trip, and an import-hygiene check.
"""

import base64
import io
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu.audio.wav import concat_with_delay
from music_generation_tpu.frontend import ScoreFrontend as JScoreFrontend
from music_generation_tpu.frontend import midi_to_note
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu.pipeline.synthesis import (
    SVSSynthesizer as JSVSSynthesizer, split_sentences as j_split)
from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.pipeline.synthesis import (
    SongSynthesizer, SVSSynthesizer, build_default_song_synthesizer)
from music_generation_tpu_torch.serve.app import (MusicGenerationService,
                                                  make_http_server)
from torch_port_util import melody_pair, t, tiny_songs, visinger_pair

LYRICS = "小小的天有大大的梦想，隐形的翅膀。带我飞过绝望"


def _jax_song(jgen, jm, params, cfg, noise):
    sentences = j_split(LYRICS)
    outs = jgen.generate_song(sentences)
    front = JScoreFrontend()
    scores, notes = [], []
    for lyric, toks, durs in outs:
        names = [midi_to_note(int(m)) if m != "rest" else "rest"
                 for m in toks]
        notes.append(names)
        scores.append(front.align(lyric, names, durs))
    svs = JSVSSynthesizer(cfg, params=params)
    max_frames, packed = svs._batch_inputs(scores)
    packed = np.asarray(packed)
    audio, mel_len, _ = jax.jit(lambda p, n: jm.apply(
        p, phones=packed[0], x_lengths=packed[3, :, 0], note_ids=packed[1],
        note_durations=packed[4].view(np.float32), shengdiao=packed[2],
        max_frames=max_frames, noise=n, method=jv.VISinger.infer))(
            params, noise[: packed.shape[1], :max_frames])
    a = audio[..., 0]
    valid = (jnp.arange(a.shape[1])[None, :]
             < (mel_len * cfg.hop_length)[:, None]).astype(a.dtype)
    a = a * valid
    peak = jnp.maximum(jnp.abs(a).max(axis=1, keepdims=True), 0.01)
    out = np.asarray((a * (32767.0 / peak)).astype(jnp.int16))
    wavs = [out[i, : int(mel_len[i]) * cfg.hop_length]
            for i in range(len(scores))]
    return notes, concat_with_delay(wavs, delay_seconds=0.2).astype(
        np.int16), max_frames


def test_slice_matches_jax_stages():
    sentences = j_split(LYRICS)
    jgen, tgen = melody_pair(sentences, seed=2, audible=True)
    jm, params, tvis = visinger_pair(seed=4)
    cfg = jm.cfg
    noise = np.random.RandomState(5).randn(
        4, 1984, cfg.inter_channels).astype(np.float32)
    want_notes, want, max_frames = _jax_song(jgen, jm, params, cfg, noise)

    svs = SVSSynthesizer(tvis.cfg, device="cpu")
    svs.model = tvis
    song = SongSynthesizer(tgen, {0: svs})
    n = t(noise)
    result = song.synthesize_song(
        LYRICS, svs_batch_fn=lambda scores: svs.synthesize_batch(
            scores, noise=n[: len(scores), :max_frames]))
    rate, got = wavfile.read(io.BytesIO(result.wav_bytes))
    assert rate == 22050
    assert result.notes == want_notes
    assert got.shape == want.shape
    assert len(got) > int(0.2 * 22050) + 22050 * 0.5  # audio, not just pad
    assert np.max(np.abs(got.astype(np.int32) - want.astype(np.int32))) <= 4


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = ServiceConfig(log_dir=str(tmp_path_factory.mktemp("logs")))
    service = MusicGenerationService(tiny_songs(), None, cfg)
    srv = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/synthesis_music",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_service_round_trip(server):
    out = _post(server, {"text": "你好世界。小小的天"})
    assert out["code"] == 200
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16
    assert len(wav) > int(0.2 * 22050)
    assert _post(server, {"keyword": "夏天"})["code"] == 201
    assert _post(server, {})["code"] == 201


def test_entry_points_refuse_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_default_song_synthesizer(tiny=True, n_speakers=1)


def test_port_imports_no_jax():
    """Every module of the port (the trainer and its CLI, the server
    variants, the seq2seq melody API and parallel/ among them), and
    chip_smoke.py, leave jax, flax and the JAX package unimported."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import music_generation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'flax', 'music_generation_tpu'))\n"
        "assert not bad, bad\n"
        "assert {p.__name__ + '.train.trainer',\n"
        "        p.__name__ + '.train.__main__',\n"
        "        p.__name__ + '.serve.variants',\n"
        "        p.__name__ + '.parallel.mesh',\n"
        "        p.__name__ + '.models.melody.seq2seq_api'}"
        " <= set(sys.modules)\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('music_generation_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


PORT_TOOLS = ("torch_eval_copy_synthesis", "torch_eval_sung_song",
              "torch_mas_vs_gt", "torch_multispeaker_demo",
              "torch_e2e_trained_demo")


def test_port_tools_import_no_jax():
    """The port's offline tools name no jax, flax or JAX-package module in
    any import statement (their functions import the port lazily), and
    loading each leaves jax unimported. tools/torch_import_pipeline.py
    converts JAX checkpoints and is exempt."""
    import ast
    tools = Path(__file__).resolve().parents[1] / "tools"
    for name in PORT_TOOLS:
        tree = ast.parse((tools / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "jax", "flax", "music_generation_tpu", "optax",
                    "orbax"), (name, mod)
    code = ("import importlib.util, sys\n"
            f"for n in {PORT_TOOLS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        n, 'tools/' + n + '.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('jax', 'flax', 'music_generation_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
