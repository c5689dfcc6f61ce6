"""HTTP song-generation service (stdlib, no flask dependency).

Twin of music_generation_tpu/serve/app.py for the model path, with the same
wire contract as the reference controllers:
  POST /synthesis_music
    body (json or form): text | keyword, singer_id (0=default, 1, 2)
    -> {code: 200, message, data: {lyrics, audio: <b64 wav>}}
    a keyword (or theme) request first generates its lyrics with the lyric
    LM (--lyric-model t5 | gpt2); under melody_v2 two keywords answer
    with canned demo songs when ./resources holds them
    errors: 201 missing input, 202 length guard (1..500) on the given or
    generated lyrics, 203 synth error
  POST /profile?seconds=N&dir=NAME -> a torch.profiler trace of live
    traffic (every thread) under <log_dir>/profile/NAME/
  GET /healthz -> {ok: true}

Run: python -m music_generation_tpu_torch.serve.app --port 5005
     [--variant svs_v6_multispeaker|svs_v5|svs_v5_multispeaker|melody_v2]
     [--decoder hifigan|istft|mb_istft] [--nsf] [--f0 predict|score]
     [--f0-residual] [--decoder-bf16] [--checkpoint-dir DIR]
     [--lyric-model t5|gpt2] [--cert-file PEM [--key-file PEM]] [--tiny]
     [--device cpu]
--checkpoint-dir (or the config's checkpoint_dir) loads a pipeline
directory (compat.checkpoints) before serving; a certificate (--cert-file
or the config's cert_file_path) serves HTTPS. --variant v1 and v1_model,
and MUSIC_BACKEND=new, exit at startup: the shell backend and the
TeleMelody melody are not ported yet.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import math
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..config import ServiceConfig
from .variants import (VARIANTS, canned_response, check_ported,
                       variant_song_synthesizer)


def make_logger(cfg: ServiceConfig) -> logging.Logger:
    logger = logging.getLogger(cfg.log_name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        os.makedirs(cfg.log_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(cfg.log_dir, f"logger_{cfg.log_name}.log"),
            encoding="utf-8")
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger


class MusicGenerationService:
    """Transport-independent request handling (unit-testable)."""

    def __init__(self, song_synthesizer, lyric_generator=None,
                 cfg: Optional[ServiceConfig] = None,
                 logger: Optional[logging.Logger] = None,
                 canned_dir: Optional[str] = None):
        self.songs = song_synthesizer
        self.lyrics = lyric_generator
        self.canned_dir = canned_dir  # melody_v2's canned demo songs
        self.cfg = cfg or ServiceConfig()
        self.logger = logger or make_logger(self.cfg)
        self._lock = threading.Lock()
        self._profile_lock = threading.Lock()  # one profiler trace at a time
        # cross-request SVS micro-batching: concurrent requests coalesce
        # their sentences into one device call (serve/batching.py); the
        # melody stage is serialized inside SongSynthesizer
        self._batcher = None
        if self.cfg.svs_batching:
            from .batching import SVSBatcher
            self._batcher = SVSBatcher(
                window_ms=self.cfg.batch_window_ms,
                max_sentences=self.cfg.max_batch_sentences)

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()

    def handle_synthesis(self, data: dict) -> dict:
        return self._handle_model_path(data)

    def _resolve_text(self, data: dict):
        """(lyrics_text, None) from a request payload, or (None, response
        dict) when the request resolves to an error or canned response."""
        text = str(data.get("text", "") or "").strip()
        if not text:
            keyword = str(data.get("keyword", "") or data.get("theme", "")
                          or "").strip()
            if not keyword:
                return None, {"code": 201,
                              "message": "输入参数错误，必须输入非空字段text！"}
            # canned demo songs for specific keywords (parity:
            # controllers_music_generation_melody_v2/syn_music.py:30-54)
            canned = canned_response(keyword, self.canned_dir)
            if canned is not None:
                self.logger.info("canned response for 关键词:%s", keyword)
                return None, canned
            if self.lyrics is None:
                return None, {"code": 201,
                              "message": "keyword 模式不可用：歌词模型未加载！"}
            self.logger.info("传入关键词:%s", keyword)
            t0 = time.time()
            text = self.lyrics.generate(keyword).replace("-", "")
            self.logger.info("生成歌词：%s", text)
            self.logger.info("歌词生成耗时：%.3f 秒。", time.time() - t0)
        else:
            self.logger.info("直接传入歌词:%s", text)

        if not (self.cfg.min_text_len <= len(text) <= self.cfg.max_text_len):
            return None, {"code": 202,
                          "message": "生成失败，传入文本必须大于1个字符，小于500个字符！"}
        return text, None

    def _handle_model_path(self, data: dict) -> dict:
        text, resp = self._resolve_text(data)
        if resp is not None:
            return resp
        try:
            # inside the try so a non-numeric singer_id yields the code-203
            # JSON the wire contract promises, not a raw 500
            singer_id = int(data.get("singer_id", 0) or 0)
            t0 = time.time()
            if self._batcher is not None:
                svs = self.songs.synthesizers.get(
                    singer_id, self.songs.synthesizers[0])
                result = self.songs.synthesize_song(
                    text, singer_id=singer_id,
                    svs_batch_fn=self._batcher.fn_for(svs))
            else:
                with self._lock:
                    result = self.songs.synthesize_song(
                        text, singer_id=singer_id)
            b64 = base64.b64encode(result.wav_bytes).decode()
            self.logger.info("音频合成耗时：%.3f 秒。", time.time() - t0)
            return {"code": 200, "message": "success！",
                    "data": {"lyrics": text, "audio": b64}}
        except Exception:
            self.logger.error("synthesis failed:\n%s", traceback.format_exc())
            return {"code": 203, "message": "服务器错误，歌声合成出错！"}


def capture_profile(trace_dir: str, seconds: float) -> str:
    """Trace every thread of the process with torch.profiler for
    ``seconds`` (the device too when a GPU is present) and write a Chrome
    trace into ``trace_dir``. Returns the trace file's path."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # requests run on the HTTP server's threads, not on the capturing one
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        time.sleep(seconds)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        time.strftime("trace_%Y%m%d_%H%M%S.json"))
    prof.export_chrome_trace(path)
    return path


def make_http_server(service: MusicGenerationService, host: str, port: int,
                     cert_file: Optional[str] = None,
                     key_file: Optional[str] = None) -> ThreadingHTTPServer:
    """The HTTP server of ``service``; with ``cert_file`` (a PEM
    certificate, its key in ``key_file`` or appended to it) it speaks
    HTTPS."""
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send_json(self, payload: dict, status: int = 200):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(status)
            self.send_header("Content-Type",
                             "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/healthz"):
                payload = {"ok": True}
                if service._batcher is not None:
                    payload["batching"] = dict(service._batcher.stats)
                self._send_json(payload)
            else:
                self._send_json({"code": 404, "message": "not found"}, 404)

        def _profile(self):
            """Capture a trace of live traffic; ?seconds=N (bounded to
            [0, 60]) sets the window. Traces land under
            <log_dir>/profile/<dir> (dir picks the subdirectory, not a
            path), one capture at a time, on a worker with a bounded
            join."""
            q = parse_qs(urlparse(self.path).query)
            try:
                seconds = float(q.get("seconds", ["2"])[0])
            except ValueError:
                seconds = math.nan
            if not math.isfinite(seconds):
                self._send_json({"ok": False,
                                 "message": "seconds must be a number"}, 400)
                return
            seconds = min(max(seconds, 0.0), 60.0)
            sub = os.path.basename(q.get("dir", ["profile"])[0]) or "profile"
            trace_dir = os.path.join(service.cfg.log_dir, "profile", sub)
            if not service._profile_lock.acquire(blocking=False):
                self._send_json({"ok": False,
                                 "message": "a trace is already running"},
                                409)
                return
            outcome = {}

            def _capture():
                try:
                    capture_profile(trace_dir, seconds)
                except Exception as e:  # reported to the client as a 500
                    service.logger.error("profile failed:\n%s",
                                         traceback.format_exc())
                    outcome["error"] = str(e)
                finally:
                    service._profile_lock.release()

            worker = threading.Thread(target=_capture, daemon=True)
            worker.start()
            worker.join(timeout=seconds + 30.0)
            if worker.is_alive():
                self._send_json({"ok": False,
                                 "message": "profiler did not finish"}, 504)
            elif "error" in outcome:
                self._send_json({"ok": False,
                                 "message": outcome["error"]}, 500)
            else:
                self._send_json({"ok": True, "trace_dir": trace_dir,
                                 "seconds": seconds})

        def do_POST(self):
            route = self.path.split("?")[0].rstrip("/")
            if route == "/profile":
                self._profile()
                return
            if route != "/synthesis_music":
                self._send_json({"code": 404, "message": "not found"}, 404)
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            try:
                if ctype.startswith("application/json"):
                    data = json.loads(raw or b"{}")
                else:
                    data = {k: v[0] for k, v in
                            parse_qs(raw.decode(errors="replace")).items()}
            except (ValueError, UnicodeDecodeError):
                data = {}
            if not isinstance(data, dict):
                data = {}
            self._send_json(service.handle_synthesis(data))

        def log_message(self, fmt, *args):
            service.logger.info("%s - %s", self.address_string(), fmt % args)

    server = ThreadingHTTPServer((host, port), Handler)
    if cert_file:
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert_file, keyfile=key_file)
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    return server


def configure(argv=None):
    """Parse the command line and resolve the service config (--config
    file, then the environment, then the flags): (args, cfg). Exits 2 for
    what the port cannot serve."""
    parser = argparse.ArgumentParser(
        description="music_generation_tpu_torch server (PyTorch/CUDA)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--host", default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny models (smoke testing)")
    parser.add_argument("--variant", default="svs_v6_multispeaker",
                        choices=sorted(VARIANTS),
                        help="reference server variant preset (v1 and "
                             "v1_model are not ported yet and exit)")
    parser.add_argument("--lyric-model", default="t5", choices=["t5", "gpt2"],
                        help="lyric LM for keyword requests")
    parser.add_argument("--decoder", default="hifigan",
                        choices=["hifigan", "istft", "mb_istft"],
                        help="SVS vocoder decoder family the checkpoints "
                             "were trained with (train --decoder)")
    parser.add_argument("--nsf", action="store_true",
                        help="SVS checkpoints were trained with `train "
                             "--nsf` (harmonic-excitation vocoder; the "
                             "model config must match the params)")
    parser.add_argument("--decoder-bf16", action="store_true",
                        help="run the vocoder decoder in bfloat16 (float32 "
                             "params, float32 output; deviation bounded as "
                             "in tests/test_bf16_decoder.py)")
    parser.add_argument("--f0", default="predict",
                        choices=["predict", "score"],
                        help="inference F0 source: 'predict' = the trained "
                             "F0Predictor (reference parity); 'score' = "
                             "frame F0 derived from the score's MIDI notes "
                             "(in tune by construction; SVSConfig.f0_mode)")
    parser.add_argument("--f0-residual", action="store_true",
                        help="checkpoints were trained with train "
                             "--f0-residual (the F0 head is a deviation "
                             "around the note pitch; SVSConfig.f0_residual)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="pipeline checkpoints to serve (svs_<id>.pt, "
                             "melody_*.pt: compat.save_pipeline, "
                             "tools/torch_export_trained_svs.py, "
                             "tools/torch_import_pipeline.py)")
    parser.add_argument("--cert-file", default=None,
                        help="PEM certificate: serve HTTPS (overrides the "
                             "config's cert_file_path)")
    parser.add_argument("--key-file", default=None,
                        help="PEM private key for the certificate (omit "
                             "when the key is appended to the cert PEM)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the models run on (default cuda; "
                             "raises when no GPU is present)")
    args = parser.parse_args(argv)
    if args.nsf and args.decoder != "hifigan":
        # NSF excitation is wired into the HiFi-GAN decoder only
        parser.error("--nsf requires --decoder hifigan")
    spec = VARIANTS[args.variant]
    try:
        check_ported(spec)
    except NotImplementedError as e:
        parser.error(str(e))

    cfg = ServiceConfig.from_file(args.config) if args.config \
        else ServiceConfig()
    cfg = ServiceConfig.from_env(cfg)
    if cfg.backend != "model":
        parser.error(f"backend {cfg.backend!r} (MUSIC_BACKEND=new): the "
                     f"shell backend (ollama/DiffRhythm pipeline) is not "
                     f"ported yet (ROADMAP.md Queue 1 item 9)")
    if args.port:
        cfg.port = args.port
    if args.host:
        cfg.host = args.host
    if args.tiny:
        cfg.tiny = True
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    if args.cert_file:
        cfg.cert_file_path = args.cert_file
    cfg.n_speakers = max(cfg.n_speakers, spec.n_speakers)
    return args, cfg


def build_songs(args, cfg: ServiceConfig, seed: int = 0):
    """The song pipeline main() serves: the variant's melody generator
    around one SVS model per speaker with the SVS flags (--decoder, --nsf,
    --f0, --f0-residual, --decoder-bf16), on --device, from ``seed``; then
    the checkpoint dir's weights, when the config names one."""
    from ..pipeline.synthesis import build_svs_synthesizers
    songs = variant_song_synthesizer(
        VARIANTS[args.variant],
        build_svs_synthesizers(cfg.tiny, cfg.n_speakers, seed=seed,
                               device=args.device, decoder=args.decoder,
                               nsf=args.nsf, f0_mode=args.f0,
                               f0_residual=args.f0_residual,
                               decoder_bf16=args.decoder_bf16),
        tiny=cfg.tiny, seed=seed, device=args.device)
    if cfg.checkpoint_dir:
        from ..compat import load_pipeline
        loaded = load_pipeline(cfg.checkpoint_dir, songs)
        logging.getLogger(cfg.log_name).info(
            "loaded checkpoints from %s: %s", cfg.checkpoint_dir,
            ", ".join(loaded) or "none")
    return songs


def main(argv=None):
    args, cfg = configure(argv)
    logger = make_logger(cfg)
    logger.info("loading models (variant=%s, decoder=%s, nsf=%s, f0=%s, "
                "f0_residual=%s, decoder_bf16=%s, tiny=%s, lyric model=%s, "
                "device=%s)...", args.variant, args.decoder, args.nsf,
                args.f0, args.f0_residual, args.decoder_bf16, cfg.tiny,
                args.lyric_model, args.device)
    import torch
    # full float32, the precision the port is held to against the JAX
    # package (cuDNN would otherwise run the convolutions in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..models.lyrics import build_lyric_generator
    songs = build_songs(args, cfg)
    lyrics = build_lyric_generator(args.lyric_model, tiny=cfg.tiny,
                                   device=args.device)
    service = MusicGenerationService(songs, lyrics, cfg, logger,
                                     canned_dir=VARIANTS[args.variant]
                                     .canned_dir)
    cert = cfg.cert_file_path
    server = make_http_server(service, cfg.host, cfg.port, cert_file=cert,
                              key_file=args.key_file)
    logger.info("serving on %s:%d%s", cfg.host, cfg.port,
                " (TLS)" if cert else "")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
