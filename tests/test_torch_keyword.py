"""Entry points of the port's keyword slice on the CPU: the server's
/profile route (torch.profiler over live traffic), the lyric-model
builders of serve.app.main, the melody microservice and the pipeline CLI.
Tiny random models throughout; no JAX is needed on the port's side.
"""

import glob
import json
import os
import runpy
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.models.lyrics import (CharTokenizer,
                                                      LyricGeneratorGPT2,
                                                      LyricGeneratorT5,
                                                      build_lyric_generator)
from music_generation_tpu_torch.models.lyrics import api as t_api
from music_generation_tpu_torch.pipeline.synthesis import (
    build_melody_generator)
from music_generation_tpu_torch.serve.app import (MusicGenerationService,
                                                  make_http_server)
from music_generation_tpu_torch.serve.melody_service import make_melody_server
from torch_port_util import tiny_songs


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(port, path, payload=None, method="POST"):
    """(HTTP status, JSON body)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    cfg = ServiceConfig(log_dir=str(tmp_path_factory.mktemp("logs")))
    service = MusicGenerationService(tiny_songs(), None, cfg)
    srv = make_http_server(service, "127.0.0.1", 0)
    thread = _serve(srv)
    yield service, srv.server_address[1]
    _stop(srv, thread)
    service.close()


def test_profile_traces_live_request(server):
    """A capture on the route's worker thread holds the ops of requests
    served meanwhile on the server's threads; a second capture is refused
    with 409 while the first runs."""
    service, port = server
    text = {"text": "你好世界。小小的天"}
    assert _request(port, "/synthesis_music", text)[1]["code"] == 200
    result = {}
    capture = threading.Thread(target=lambda: result.update(
        out=_request(port, "/profile?seconds=2&dir=../run1")))
    capture.start()
    deadline = time.time() + 30
    while not service._profile_lock.locked() and time.time() < deadline:
        time.sleep(0.005)
    assert _request(port, "/profile?seconds=1")[0] == 409
    served = 0
    while capture.is_alive():
        assert _request(port, "/synthesis_music", text)[1]["code"] == 200
        served += 1
    capture.join(timeout=60)
    assert served >= 2
    status, out = result["out"]
    assert status == 200 and out["ok"] and out["seconds"] == 2.0
    # `dir` names a subdirectory of <log_dir>/profile, never a path
    assert out["trace_dir"] == os.path.join(service.cfg.log_dir, "profile",
                                            "run1")
    (trace,) = glob.glob(os.path.join(out["trace_dir"], "*.json"))
    with open(trace, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the HiFi-GAN decoder of the requests served during the capture
    assert "aten::conv_transpose1d" in names


def test_profile_bounds_seconds(server):
    _, port = server
    for bad in ("abc", "nan", "inf"):
        status, out = _request(port, f"/profile?seconds={bad}")
        assert status == 400 and not out["ok"]
    status, out = _request(port, "/profile?seconds=-3&dir=clamped")
    assert status == 200 and out["ok"] and out["seconds"] == 0.0


def test_main_lyric_model_builders():
    """serve.app.main's lyric LMs: the JAX server's tiny widths on the
    CharTokenizer, T5 with the tokenizer's special ids; no GPU, no build."""
    tok = CharTokenizer()
    t5 = build_lyric_generator("t5", tiny=True, device="cpu")
    assert isinstance(t5, LyricGeneratorT5)
    assert (t5.cfg.vocab_size, t5.cfg.eos_token_id, t5.cfg.pad_token_id,
            t5.cfg.decoder_start_token_id) == (tok.vocab_size, tok.eos_id,
                                               tok.pad_id, tok.pad_id)
    assert (t5.cfg.d_model, t5.cfg.num_layers) == (32, 1)
    gpt2 = build_lyric_generator("gpt2", tiny=True, device="cpu")
    assert isinstance(gpt2, LyricGeneratorGPT2)
    assert (gpt2.cfg.vocab_size, gpt2.cfg.n_layer) == (tok.vocab_size, 1)
    with pytest.raises(ValueError):
        build_lyric_generator("bert", tiny=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_lyric_generator("t5", tiny=True)


class FakeMelodyGen:
    def generate(self, lyrics):
        n = len(lyrics)
        return lyrics + "AP", ["60"] * n + ["rest"], [0.4] * n + [0.6]


@pytest.mark.parametrize("real", [False, True], ids=["fake", "port"])
def test_melody_service_contract(real):
    gen = (build_melody_generator(tiny=True, device="cpu") if real
           else FakeMelodyGen())
    srv = make_melody_server(gen, "127.0.0.1", 0)
    thread = _serve(srv)
    try:
        port = srv.server_address[1]
        status, out = _request(port, "/?lyrics=%E4%BD%A0%E5%A5%BD",
                               method="GET")
        assert status == 200
        assert out["lyrics"] == "你好AP"
        assert out["pitch"][-1] == "rest" and len(out["pitch"]) == 3
        assert len(out["durations"]) == len(out["pitch"])
        assert _request(port, "/", method="GET")[1]["code"] == 201
    finally:
        _stop(srv, thread)


def test_pipeline_cli_keyword(tmp_path, monkeypatch):
    """python -m music_generation_tpu_torch.pipeline out.wav --keyword 夏天
    --tiny --device cpu writes a WAV (decode budget cut to 12 tokens to
    keep the song short)."""
    out = tmp_path / "song.wav"
    monkeypatch.setattr(t_api, "T5_MAX_LENGTH", 12)
    monkeypatch.setattr(sys, "argv", [
        "pipeline", str(out), "--keyword", "夏天", "--tiny", "--device",
        "cpu"])
    runpy.run_module("music_generation_tpu_torch.pipeline",
                     run_name="__main__")
    rate, wav = wavfile.read(out)
    assert rate == 22050 and wav.dtype == np.int16
    assert len(wav) > int(0.2 * 22050) and np.any(wav != 0)
