"""The port's shell-pipeline variant against the JAX package's.

pipeline/lrc.py, serve/modes.py and pipeline/shell_backend.py are host
code: on the same input the port's must give the JAX package's strings,
files and responses exactly (tolerance: none, byte for byte). The external
engines are stubs the tests write: an ``ollama`` script on PATH and a
DiffRhythm repository whose infer/infer.py writes a WAV. The service
tests run the port's tiny models on the CPU.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import stat
import threading
import urllib.request

import numpy as np
import pytest
from scipy.io import wavfile

from music_generation_tpu.pipeline import lrc as j_lrc
from music_generation_tpu.pipeline import shell_backend as j_shell
from music_generation_tpu.serve import app as j_app
from music_generation_tpu.serve import modes as j_modes
from music_generation_tpu_torch.config import ServiceConfig
from music_generation_tpu_torch.pipeline import lrc as t_lrc
from music_generation_tpu_torch.pipeline import shell_backend as t_shell
from music_generation_tpu_torch.serve import app as t_app
from music_generation_tpu_torch.serve import modes as t_modes

TEMPLATE = "\n".join(j_shell.template_lyrics("玫瑰"))
PAYLOADS = {
    "keyword": {"keyword": "玫瑰", "style": "民谣", "audio_length": 30},
    "theme": {"theme": "夏天的海", "ref_prompt": "sad,piano"},
    "keyword_beats_all": {"keyword": "海", "text": "长歌词。",
                          "raw_lyrics": "x"},
    "text_topic": {"text": "星空"},
    "text_long": {"text": "这是一句，有标点的长歌词内容。第二句在这里"},
    "text_multiline": {"text": "第一行\n第二行"},
    "raw_lyrics": {"raw_lyrics": "第一行。第二行\n\n第三行", "audio_length": 0},
    "legacy_template_raw": {"raw_lyrics": TEMPLATE},
    "legacy_template_text": {
        "text": "月亮在夜色里慢慢发光，沿着河岸把心事流淌，风把故事吹成了月光"},
    "empty": {},
    "blank": {"text": "  ", "keyword": None, "style": ""},
}
LRC_TEXTS = [
    "[00:10,50] later\n[00:05:2]早\n[00:05.20] dup\n[ar:x]\n[ti:y]\n",
    "[01:02.345]a\n[01:02.344]b[00:00.9]c\n\n[offset:+10]\n[al:z]\n",
    "no tags at all\n",
    "",
]
LYRIC_LINES = [
    ["第一句歌词很好", "第二句，", "第三句歌词结束。"],
    ["短", "", "一个非常非常非常非常非常非常长的句子结尾没有标点"] * 3,
    ["a b c!", "？"],
]


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_decide_mode_matches_jax(name):
    data = PAYLOADS[name]
    assert t_modes.decide_mode(dict(data)) == j_modes.decide_mode(dict(data))
    text = str(data.get("raw_lyrics") or data.get("text") or "")
    for fn in ("looks_like_topic", "detect_legacy_template",
               "extract_theme_from_template", "normalize_to_lines"):
        assert getattr(t_modes, fn)(text) == getattr(j_modes, fn)(text), fn


@pytest.mark.parametrize("case", range(len(LYRIC_LINES)))
def test_lrc_matches_jax(case):
    lines = LYRIC_LINES[case]
    header = {"ti": "歌", "ar": "x", "offset": "0"} if case == 1 else None
    params = (t_lrc.LrcParams(), t_lrc.LrcParams(base=0.1, per_char=0.01,
                                                  min_dur=0.001, gap=0.0))
    for p in params:
        jp = j_lrc.LrcParams(**p.__dict__)
        got = t_lrc.lyrics_to_lrc(lines, p, header)
        assert got == j_lrc.lyrics_to_lrc(lines, jp, header)
        assert t_lrc.parse_lrc(got) == j_lrc.parse_lrc(got)
    raw = LRC_TEXTS[case]
    assert t_lrc.normalize_lrc(raw) == j_lrc.normalize_lrc(raw)
    assert t_lrc.parse_lrc(raw) == j_lrc.parse_lrc(raw)
    for t in (0.0, 0.004, 59.995, 61.5, 3600.126, -2.0):
        assert t_lrc.seconds_to_tag(t) == j_lrc.seconds_to_tag(t)


def _script(path, text: str) -> None:
    path.write_text(text, encoding="utf-8")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def _engines(tmp_path, monkeypatch, ollama: bool):
    """Stub ollama on PATH (two lines of lyrics) and a stub DiffRhythm
    repository whose infer/infer.py writes a WAV made from the LRC it is
    given; returns the repository's path."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if ollama:
        _script(bin_dir / "ollama",
                "#!/bin/sh\nprintf '海风吹过了沙滩\\n\\n星星落进我心房\\n'\n")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    repo = tmp_path / "diffrhythm"
    (repo / "infer").mkdir(parents=True)
    (repo / "infer" / "infer.py").write_text(
        "import argparse, os, wave\n"
        "p = argparse.ArgumentParser()\n"
        "for a in ('--lrc-path', '--ref-prompt', '--audio-length',\n"
        "          '--repo-id', '--output-dir', '--batch-infer-num'):\n"
        "    p.add_argument(a)\n"
        "p.add_argument('--chunked', action='store_true')\n"
        "a = p.parse_args()\n"
        "lrc = open(a.lrc_path, encoding='utf-8').read().encode()\n"
        "with wave.open(os.path.join(a.output_dir, 'out.wav'), 'wb') as w:\n"
        "    w.setnchannels(1); w.setsampwidth(2); w.setframerate(44100)\n"
        "    w.writeframes(lrc * int(a.audio_length))\n", encoding="utf-8")
    return str(repo)


def _lyric_fn(theme: str) -> str:
    return f"{theme}的歌。第二句在这里\n第三句"


# (payload, ollama on PATH, lyric_fn, DiffRhythm repository)
SHELL_CASES = {
    "ollama": ({"keyword": "海边", "audio_length": 3}, True, True, False),
    "lyric_fn": ({"theme": "夏天"}, False, True, False),
    "template": ({"keyword": "玫瑰", "audio_length": 1}, False, False, False),
    "raw_lyrics": ({"raw_lyrics": "自定义第一行\n自定义第二行"}, True, True,
                   False),
    "diffrhythm": ({"keyword": "星空", "audio_length": 2,
                    "ref_prompt": "calm"}, False, True, True),
}
RUN_FILES = ("request.json", "lyrics.txt", "rough.lrc", "final.lrc",
             "song.wav")


@pytest.mark.parametrize("case", sorted(SHELL_CASES))
def test_shell_backend_run_matches_jax(case, tmp_path, monkeypatch):
    """Two requests through each package's ShellPipelineBackend, each in a
    root of its own: every file of both request directories, the `latest`
    pointer and the results (paths taken relative to the root) agree byte
    for byte."""
    payload, ollama, use_fn, diffrhythm = SHELL_CASES[case]
    repo = _engines(tmp_path, monkeypatch, ollama)
    monkeypatch.setenv("MODEL", "stub-model")
    outs = {}
    for tag, mod in (("jax", j_shell), ("port", t_shell)):
        root = tmp_path / tag
        backend = mod.ShellPipelineBackend(
            root=str(root), lyric_fn=_lyric_fn if use_fn else None,
            diffrhythm_repo=repo if diffrhythm else None)
        assert backend.ollama_model == "stub-model"
        results = [backend.run(dict(payload)),
                   backend.run({"raw_lyrics": "再来一行"})]
        outs[tag] = (root, [{k: v.replace(str(root), "ROOT")
                             for k, v in r.items()} for r in results])
    (j_root, j_res), (t_root, t_res) = outs["jax"], outs["port"]
    assert t_res == j_res
    assert [r["request_id"] for r in t_res] == ["REQ-00001", "REQ-00002"]
    for req in ("REQ-00001", "REQ-00002"):
        for name in RUN_FILES:
            got = (t_root / "requests" / req / name).read_bytes()
            assert got == (j_root / "requests" / req / name).read_bytes(), \
                (req, name)
    assert os.readlink(t_root / "latest") == str(
        t_root / "requests" / "REQ-00002")
    rate, wav = wavfile.read(t_res[0]["audio_path"].replace(
        "ROOT", str(t_root)))
    assert rate == 44100
    if diffrhythm:  # the stub's WAV, copied
        assert len(wav) == len(
            (t_root / "requests" / "REQ-00001" / "final.lrc").read_bytes())
    else:  # the reference's silent fake backend, at most 1 s
        assert not wav.any() and len(wav) == 44100 * min(
            payload.get("audio_length", 95) or 95, 1)
    if ollama and "raw_lyrics" not in payload:
        assert t_res[0]["lyrics"] == "海风吹过了沙滩\n星星落进我心房"


def _logger():
    logger = logging.getLogger("test_torch_shell_pipeline")
    logger.handlers[:] = [logging.NullHandler()]
    logger.propagate = False
    return logger


def test_handle_pipeline_matches_jax(tmp_path, monkeypatch):
    """handle_synthesis under backend="shell" with no model path behind it:
    201 for an empty payload, 200 through the shell, 203 when the shell
    raises; the port's responses equal the JAX service's."""
    monkeypatch.delenv("DIFFRHYTHM_REPO", raising=False)
    _engines(tmp_path, monkeypatch, ollama=False)
    answers = {}
    for tag, app_mod, shell_mod in (("jax", j_app, j_shell),
                                    ("port", t_app, t_shell)):
        cfg = app_mod.ServiceConfig(backend="shell", log_dir=str(tmp_path))
        good = shell_mod.ShellPipelineBackend(root=str(tmp_path / tag),
                                              lyric_fn=_lyric_fn)
        (tmp_path / "not_a_dir").write_text("a file")
        bad = shell_mod.ShellPipelineBackend(root=str(tmp_path / "not_a_dir"))
        rows = []
        for backend in (good, bad):
            service = app_mod.MusicGenerationService(
                None, None, cfg, _logger(), shell_backend=backend)
            for payload in ({}, {"keyword": "春天"},
                            {"raw_lyrics": "第一行\n第二行"}):
                rows.append(service.handle_synthesis(dict(payload)))
        answers[tag] = rows
    assert answers["port"] == answers["jax"]
    assert [r["code"] for r in answers["port"]] == [201, 200, 200,
                                                    201, 203, 203]
    assert answers["port"][1]["data"]["mode"] == "theme_from_keyword"


@pytest.fixture(scope="module")
def v1_service(tmp_path_factory):
    """serve.app's own construction with --variant v1 (tiny models on the
    CPU), its shell root and logs in a temporary directory."""
    d = tmp_path_factory.mktemp("v1")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        args, cfg = t_app.configure(["--variant", "v1", "--tiny", "--device",
                                     "cpu"])
        cfg.log_dir = str(d / "logs")
        service = t_app.build_service(args, cfg)
    finally:
        os.chdir(cwd)
    service.shell_backend.root = str(d / "music_pipeline_data")
    yield service, d
    service.close()


def test_v1_service_shell_and_fallback(v1_service, monkeypatch):
    """--variant v1: the shell backend answers first (its lyric_fn is the
    service's lyric LM); when the shell raises, the model path answers 200
    with an int16 WAV sung by the tiny models."""
    monkeypatch.delenv("DIFFRHYTHM_REPO", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")  # no ollama
    service, d = v1_service
    assert service.cfg.backend == "shell"
    assert service.shell_backend.lyric_fn == service.lyrics.generate
    assert service.handle_synthesis({})["code"] == 201
    out = service.handle_synthesis({"raw_lyrics": "你好世界\n小小的天"})
    assert out["code"] == 200 and out["data"]["mode"] == "raw_lyrics"
    assert out["data"]["lyrics"] == "你好世界\n小小的天"
    assert out["data"]["lrc"] == t_lrc.normalize_lrc(t_lrc.lyrics_to_lrc(
        ["你好世界", "小小的天"]))
    calls = []
    lyric_fn = service.shell_backend.lyric_fn
    service.shell_backend.lyric_fn = lambda kw: calls.append(kw) or \
        lyric_fn(kw)
    out = service.handle_synthesis({"keyword": "夏天"})
    assert out["code"] == 200 and calls == ["夏天"]
    root = service.shell_backend.root
    (d / "a_file").write_text("x")
    service.shell_backend.root = str(d / "a_file")
    try:
        out = service.handle_synthesis({"text": "你好世界"})
    finally:
        service.shell_backend.root = root
    assert out["code"] == 200 and "mode" not in out["data"], out
    assert out["data"]["lyrics"] == "你好世界"
    rate, wav = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 22050 and wav.dtype == np.int16 and np.abs(wav).max() > 0


@pytest.mark.parametrize("how", ["variant_v1", "MUSIC_BACKEND=new"])
def test_serve_main_serves_shell_backend(how, tmp_path, monkeypatch):
    """serve.app.main() itself, its server on a free local port: --variant
    v1 and MUSIC_BACKEND=new are served, and a topic-like text request is
    answered through the shell (mode, lyrics, lrc and the 44.1 kHz WAV)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DIFFRHYTHM_REPO", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    argv = ["--tiny", "--device", "cpu"]
    if how == "variant_v1":
        argv += ["--variant", "v1"]
    else:
        monkeypatch.setenv("MUSIC_BACKEND", "new")
    make_server, seen = t_app.make_http_server, []

    def free_port_server(service, host, port, **tls):
        srv = make_server(service, "127.0.0.1", 0, **tls)

        def request():
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}"
                    "/synthesis_music",
                    data=json.dumps({"text": "星空"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    seen.append(json.loads(resp.read()))
            finally:
                srv.shutdown()
        seen.append(service)
        threading.Thread(target=request, daemon=True).start()
        return srv

    monkeypatch.setattr(t_app, "make_http_server", free_port_server)
    t_app.main(argv)
    service, out = seen
    assert service.cfg.backend == "shell"
    assert out["code"] == 200 and out["data"]["mode"] == "theme_from_text"
    assert out["data"]["lrc"].startswith("[00:00.00] ")
    rate, _ = wavfile.read(io.BytesIO(base64.b64decode(
        out["data"]["audio"])))
    assert rate == 44100
    assert (tmp_path / "music_pipeline_data" / "requests" /
            "REQ-00001" / "final.lrc").exists()
    assert ServiceConfig().backend == "model"
