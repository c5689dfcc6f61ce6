"""The rest of the port's served surface on the CPU, against the JAX
server's contract: serve.app's main() with --fused and --warmup (the
fused path for a request alone in flight, the staged path and its batcher
for concurrent ones, "fused" in /healthz), POST /synthesis_music_stream
(chunked audio/wav), GET /syn_outputs/ with its traversal guard, the
proxy, and utils.observability. Tiny random models throughout.
"""

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.pipeline.fused import FusedSongSynthesizer
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.serve.proxy import make_proxy
from music_generation_tpu_torch.utils import (DeviceStatsPoller, StageTimer,
                                              device_memory_stats,
                                              profile_trace)

TEXT = "你好世界。隐形的翅膀"


def _request(port, path, payload=None, timeout=120):
    """(status, headers, body bytes) of a POST (payload given) or a GET."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(port, payload, path="/synthesis_music"):
    return json.loads(_request(port, path, payload)[2])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _run_main(argv, records):
    """serve.app.main(argv) on a thread, its server on a free local port:
    (server, service, thread) once it serves."""
    ready, box = threading.Event(), {}
    make = t_app.make_http_server

    def free_port_server(service, host, port, **tls):
        box["server"] = make(service, "127.0.0.1", 0, **tls)
        box["service"] = service
        ready.set()
        return box["server"]

    root = logging.getLogger()
    root.addHandler(records)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_app, "make_http_server", free_port_server)
        thread = threading.Thread(target=t_app.main, args=(argv,),
                                  daemon=True)
        thread.start()
        assert ready.wait(300), "the server did not start"
    return box["server"], box["service"], thread


@pytest.fixture(scope="module")
def fused_server(tmp_path_factory):
    """main(["--tiny", "--device", "cpu", "--fused", "--warmup"]), in a
    directory of its own."""
    records = _Records()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("fused_server"))
        server, service, thread = _run_main(
            ["--tiny", "--device", "cpu", "--fused", "--warmup"], records)
        yield server.server_address[1], service, records
        server.shutdown()
        thread.join(timeout=60)
        logging.getLogger().removeHandler(records)
    assert not thread.is_alive()


def test_warmup_logs_its_requests(fused_server):
    _, service, records = fused_server
    assert service.warmup["code"] == 200
    assert service.warmup["request_s"] > 0 and service.warmup["staged_s"] > 0
    assert any(m.startswith("warmup request code=200 in")
               for m in records.messages)
    assert any(m.startswith("staged-path warmup in")
               for m in records.messages)


def test_lone_request_takes_the_fused_path(fused_server):
    port, service, _ = fused_server
    assert isinstance(service.fused, FusedSongSynthesizer)
    before = dict(service.path_counts)
    out = _post(port, {"text": TEXT})
    assert out["code"] == 200 and out["data"]["lyrics"] == TEXT
    assert service.path_counts == {"fused": before["fused"] + 1,
                                   "staged": before["staged"]}


def test_healthz_says_fused(fused_server):
    port = fused_server[0]
    status, _, body = _request(port, "/healthz")
    payload = json.loads(body)
    assert status == 200 and payload["ok"] and payload["fused"] is True
    assert "batching" in payload


def test_concurrent_requests_take_the_staged_path(fused_server):
    """While one request holds the fused path, a second one is routed to
    the staged path and through the batcher."""
    port, service, _ = fused_server
    gate = threading.Event()
    fused_song = service.fused.synthesize_song

    def held(*args, **kwargs):
        assert gate.wait(60)
        return fused_song(*args, **kwargs)

    before = dict(service.path_counts)
    calls = service._batcher.stats["requests"]
    answers = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(service.fused, "synthesize_song", held)
        first = threading.Thread(
            target=lambda: answers.append(_post(port, {"text": TEXT})))
        first.start()
        deadline = time.time() + 60
        while service.path_counts["fused"] == before["fused"]:
            assert time.time() < deadline
            time.sleep(0.01)
        second = _post(port, {"text": TEXT, "singer_id": 1})
        gate.set()
        first.join(timeout=120)
    assert second["code"] == 200 and answers[0]["code"] == 200
    assert service.path_counts == {"fused": before["fused"] + 1,
                                   "staged": before["staged"] + 1}
    status, _, body = _request(port, "/healthz")
    assert json.loads(body)["batching"]["requests"] == calls + 1


def test_stream_endpoint_sends_chunked_wav(fused_server):
    port = fused_server[0]
    status, headers, body = _request(port, "/synthesis_music_stream",
                                     {"text": TEXT})
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["Transfer-Encoding"] == "chunked"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert body[4:8] == body[40:44] == b"\xff\xff\xff\xff"
    pcm = np.frombuffer(body[44:], np.int16)
    lead = int(0.2 * 22050)
    assert not pcm[:lead].any() and len(pcm) > lead + 22050


def test_stream_errors_keep_the_json_contract(fused_server):
    """An empty request answers 201 JSON; a failure before the first audio
    byte (here in the melody) answers 203 JSON, not a broken stream."""
    port, service, _ = fused_server
    assert _post(port, {}, "/synthesis_music_stream")["code"] == 201

    def failing(text, singer_id=0):
        raise RuntimeError("melody failed")
        yield  # a generator, as stream_song is

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(service.songs, "stream_song", failing)
        out = _post(port, {"text": TEXT}, "/synthesis_music_stream")
    assert out["code"] == 203


def test_fused_is_ignored_under_melody_v2(tmp_path, monkeypatch):
    """melody_v2's seq2seq melody has no whole-song form: --fused warns and
    the server answers on the staged path."""
    monkeypatch.chdir(tmp_path)
    records = _Records()
    server, service, thread = _run_main(
        ["--tiny", "--device", "cpu", "--fused", "--variant", "melody_v2"],
        records)
    try:
        out = _post(server.server_address[1], {"text": TEXT})
        status, _, body = _request(server.server_address[1], "/healthz")
    finally:
        server.shutdown()
        thread.join(timeout=60)
        logging.getLogger().removeHandler(records)
    assert out["code"] == 200 and service.fused is None
    assert service.path_counts == {"fused": 0, "staged": 1}
    assert "fused" not in json.loads(body)
    assert any("--fused needs the transformer melody" in m
               for m in records.messages)


@pytest.fixture
def static_server(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "syn_outputs" / "run").mkdir(parents=True)
    (tmp_path / "syn_outputs" / "run" / "song.wav").write_bytes(b"RIFFdata")
    (tmp_path / "syn_outputs" / "song.lrc").write_text("[00:00]歌",
                                                       encoding="utf-8")
    (tmp_path / "secret.txt").write_text("no")
    service = t_app.MusicGenerationService(
        None, cfg=ServiceConfig(log_dir=str(tmp_path / "logs"),
                                svs_batching=False))
    server = t_app.make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, args=(0.05,),
                              daemon=True)
    thread.start()
    yield server.server_address[1]
    server.shutdown()
    thread.join(timeout=30)


def test_syn_outputs_serves_files(static_server):
    status, headers, body = _request(static_server,
                                     "/syn_outputs/run/song.wav")
    assert (status, headers["Content-Type"], body) == (200, "audio/wav",
                                                       b"RIFFdata")
    status, headers, body = _request(static_server, "/syn_outputs/song.lrc")
    assert status == 200 and body.decode() == "[00:00]歌"
    assert headers["Content-Type"].startswith("text/plain")


@pytest.mark.parametrize("path", ["/syn_outputs/../secret.txt",
                                  "/syn_outputs/run/../../secret.txt",
                                  "/syn_outputs/missing.wav",
                                  "/syn_outputs/run"])
def test_syn_outputs_refuses_traversal_and_missing(static_server, path):
    status, _, body = _request(static_server, path)
    assert status == 404 and json.loads(body)["code"] == 404


def test_proxy_relays_and_reports_a_down_upstream(fused_server):
    port = fused_server[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    proxies = [ThreadingHTTPServer(("127.0.0.1", 0), make_proxy(
        f"http://127.0.0.1:{p}", timeout=60)) for p in (port, closed)]
    threads = [threading.Thread(target=p.serve_forever, daemon=True)
               for p in proxies]
    for t in threads:
        t.start()
    try:
        up, down = (p.server_address[1] for p in proxies)
        assert json.loads(_request(up, "/healthz")[2]) == {"ok": True}
        out = _post(up, {"text": "你好世界"})
        assert out["code"] == 200 and out["data"]["audio"]
        status, _, body = _request(down, "/synthesis_music", {"text": "x"})
        assert status == 504 and json.loads(body)["code"] == 504
    finally:
        for p, t in zip(proxies, threads):
            p.shutdown()
            t.join(timeout=30)


def test_device_memory_stats_and_poller():
    """Without a GPU: one entry holding only the device; the poller logs
    nothing and stops."""
    assert device_memory_stats() == [{"device": "cpu"}]
    records = _Records()
    logger = logging.getLogger("test_device_stats")
    logger.addHandler(records)
    poller = DeviceStatsPoller(interval_s=0.01, logger=logger).start()
    time.sleep(0.05)
    poller.stop()
    assert not poller._thread.is_alive() and records.messages == []


def test_stage_timer_and_profile_trace(tmp_path):
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("melody"):
            time.sleep(0.01)
    with timer.stage("svs"):
        pass
    summary = timer.summary()
    assert summary["melody"]["count"] == 2
    assert summary["melody"]["total_s"] >= 0.02
    assert summary["svs"]["count"] == 1
    with profile_trace(str(tmp_path / "trace")) as path:
        np.ones(8).sum()
    assert json.loads(open(path).read())["traceEvents"] is not None
