"""HTTP song-generation service (stdlib, no flask dependency).

Twin of music_generation_tpu/serve/app.py, with the same wire contract as
the reference controllers:
  POST /synthesis_music
    body (json or form): text | keyword, singer_id (0=default, 1, 2)
    -> {code: 200, message, data: {lyrics, audio: <b64 wav>}}
    a keyword (or theme) request first generates its lyrics with the lyric
    LM (--lyric-model t5 | gpt2); under melody_v2 two keywords answer
    with canned demo songs when ./resources holds them
    errors: 201 missing input, 202 length guard (1..500) on the given or
    generated lyrics, 203 synth error
    under the shell backend (--variant v1, or MUSIC_BACKEND=new) the
    request first goes through the mode heuristics (serve/modes.py) and
    pipeline/shell_backend.py (ollama or the lyric LM, LRC, DiffRhythm or
    its silent WAV): {code: 200, data: {mode, lyrics, lrc, audio}}; when
    that does not answer 200, the model path above answers
  POST /synthesis_music_stream (same body) -> audio/wav with
    Transfer-Encoding: chunked: a header of unknown length, then one HTTP
    chunk per vocoder decode window; an error before the first audio byte
    answers the JSON contract above
  POST /profile?seconds=N&dir=NAME -> a torch.profiler trace of live
    traffic (every thread) under <log_dir>/profile/NAME/
  GET /syn_outputs/<path> -> a file under ./syn_outputs
  GET /healthz -> {ok: true[, batching: {...}][, decode: {...}]
                  [, fused: true]}

Run: python -m music_generation_tpu_torch.serve.app --port 5005
     [--variant svs_v6_multispeaker|svs_v5|svs_v5_multispeaker|melody_v2|
                v1_model|v1]
     [--decoder hifigan|istft|mb_istft] [--nsf] [--f0 predict|score]
     [--f0-residual] [--decoder-bf16] [--checkpoint-dir DIR]
     [--lyric-model t5|gpt2] [--fused] [--warmup]
     [--cert-file PEM [--key-file PEM]] [--tiny] [--device cpu]
--checkpoint-dir (or the config's checkpoint_dir) loads a pipeline
directory (compat.checkpoints) before serving; a certificate (--cert-file
or the config's cert_file_path) serves HTTPS; a directory of plain
(non-AE) VISinger files serves that variant. --fused serves a lone
request through pipeline/fused.py and concurrent ones through the staged
path and its batcher (a melody with no whole-song form, melody_v2's or
v1_model's TeleMelody, always takes the staged path); --warmup answers one
song before serving. v1_model mixes the rendered MIDI accompaniment under
the vocal. --variant v1 and MUSIC_BACKEND=new serve through the shell
backend, its requests under ./music_pipeline_data, with the lyric LM as its
in-process lyric source and the variant's model path behind it.
"""

from __future__ import annotations

import argparse
import base64
import itertools
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

from ..audio.wav import streaming_wav_header
from ..config import ServiceConfig
from ..utils.observability import profile_trace
from .variants import VARIANTS, canned_response, variant_song_synthesizer


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


WARMUP_TEXT = "你好世界。小小的天有大大的梦想。隐形的翅膀。带我飞过绝望"


class MusicGenerationService:
    """Transport-independent request handling (unit-testable).

    ``fused_synthesizer`` (pipeline/fused.py), when given, is picked by
    load: a request alone in flight takes it, concurrent requests take the
    staged path so that the SVS batcher can coalesce them.
    ``path_counts`` counts the requests each path answered.
    ``shell_backend`` (pipeline/shell_backend.py) answers first when
    ``cfg.backend`` is "shell"."""

    def __init__(self, song_synthesizer, lyric_generator=None,
                 cfg: Optional[ServiceConfig] = None,
                 logger: Optional[logging.Logger] = None,
                 canned_dir: Optional[str] = None,
                 fused_synthesizer=None, shell_backend=None):
        self.songs = song_synthesizer
        self.lyrics = lyric_generator
        self.shell_backend = shell_backend
        self.canned_dir = canned_dir  # melody_v2's canned demo songs
        self.cfg = cfg or ServiceConfig()
        self.logger = logger or make_logger(self.cfg)
        self.fused = fused_synthesizer
        self.path_counts = {"fused": 0, "staged": 0}
        self.warmup = None  # build_service's warm_up outcome (--warmup)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
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

    def handle_pipeline(self, data: dict) -> dict:
        """Shell-pipeline path (v1 controller parity): mode heuristics ->
        ShellPipelineBackend -> {mode, lyrics, lrc, audio}."""
        from .modes import decide_mode
        mode, payload = decide_mode(data)
        if mode is None:
            return {"code": 201,
                    "message": "输入参数错误：请提供 keyword/theme（主题）或 "
                               "text/raw_lyrics（歌词）。"}
        self.logger.info("判定模式：%s；payload_keys=%s", mode,
                         list(payload.keys()))
        try:
            result = self.shell_backend.run(payload)
            with open(result["audio_path"], "rb") as f:
                audio_b64 = base64.b64encode(f.read()).decode("ascii")
            return {"code": 200, "message": "success！",
                    "data": {"mode": mode, "lyrics": result["lyrics"],
                             "lrc": result["lrc"], "audio": audio_b64}}
        except Exception:
            self.logger.error("pipeline failed:\n%s", traceback.format_exc())
            return {"code": 203, "message": "服务器错误：生成失败（pipeline）"}

    def handle_synthesis(self, data: dict) -> dict:
        if self.cfg.backend == "shell" and self.shell_backend is not None:
            result = self.handle_pipeline(data)
            # graceful fallback to the model path (parity:
            # controllers_music_generation_svs_v5/syn_music.py:97-120)
            if result["code"] == 200 or self.songs is None:
                return result
            self.logger.info("shell backend failed -> falling back to model "
                             "path")
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

    def stream_synthesis(self, data: dict):
        """The streaming model path: a generator of int16 numpy chunks
        (SongSynthesizer.stream_song: the melody, the 0.2 s lead-in, then
        one chunk per vocoder decode window), or a response dict (an error
        or a canned keyword song) to send as plain JSON."""
        text, resp = self._resolve_text(data)
        if resp is not None:
            return resp
        try:
            singer_id = int(data.get("singer_id", 0) or 0)
        except (TypeError, ValueError):
            return {"code": 203, "message": "服务器错误，歌声合成出错！"}
        return self.songs.stream_song(text, singer_id=singer_id)

    def _synthesize(self, text: str, singer_id: int):
        with self._inflight_lock:
            self._inflight += 1
            alone = self._inflight == 1
            path = ("fused" if self.fused is not None
                    and (alone or self._batcher is None) else "staged")
            self.path_counts[path] += 1
        try:
            if path == "fused":
                with self._lock:
                    return self.fused.synthesize_song(text,
                                                      singer_id=singer_id)
            if self._batcher is not None:
                svs = self.songs.synthesizers.get(
                    singer_id, self.songs.synthesizers[0])
                return self.songs.synthesize_song(
                    text, singer_id=singer_id,
                    svs_batch_fn=self._batcher.fn_for(svs))
            with self._lock:
                return self.songs.synthesize_song(text, singer_id=singer_id)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _handle_model_path(self, data: dict) -> dict:
        text, resp = self._resolve_text(data)
        if resp is not None:
            return resp
        try:
            # inside the try so a non-numeric singer_id yields the code-203
            # JSON the wire contract promises, not a raw 500
            singer_id = int(data.get("singer_id", 0) or 0)
            t0 = time.time()
            result = self._synthesize(text, singer_id)
            b64 = base64.b64encode(result.wav_bytes).decode()
            self.logger.info("音频合成耗时：%.3f 秒。", time.time() - t0)
            return {"code": 200, "message": "success！",
                    "data": {"lyrics": text, "audio": b64}}
        except Exception:
            self.logger.error("synthesis failed:\n%s", traceback.format_exc())
            return {"code": 203, "message": "服务器错误，歌声合成出错！"}


def capture_profile(trace_dir: str, seconds: float) -> str:
    """Trace every thread of the process for ``seconds``
    (utils.observability.profile_trace) into ``trace_dir``. Returns the
    trace file's path."""
    with profile_trace(trace_dir) as path:
        time.sleep(seconds)
    return path


def syn_outputs_file(url_path: str) -> Optional[str]:
    """The file under ./syn_outputs that GET /syn_outputs/<rel> names, or
    None when it is missing or its normalised path leaves the directory."""
    rel = os.path.normpath(url_path[len("/syn_outputs/"):])
    base = os.path.abspath("./syn_outputs")
    full = os.path.abspath(os.path.join(base, rel))
    if full.startswith(base + os.sep) and os.path.isfile(full):
        return full
    return None


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
                synths = getattr(service.songs, "synthesizers", None)
                if synths:  # the batched decode's crop, every singer's
                    stats = [s.decode_stats for s in synths.values()]
                    payload["decode"] = {k: sum(d[k] for d in stats)
                                         for k in stats[0]}
                if service.fused is not None:
                    payload["fused"] = True
                self._send_json(payload)
            elif self.path.startswith("/syn_outputs/"):
                self._static(syn_outputs_file(self.path))
            else:
                self._send_json({"code": 404, "message": "not found"}, 404)

        def _static(self, full: Optional[str]):
            """A stored output (the reference's demo UI reads them)."""
            if full is None:
                self._send_json({"code": 404, "message": "not found"}, 404)
                return
            with open(full, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type",
                             "audio/wav" if full.endswith(".wav")
                             else "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

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
            if route not in ("/synthesis_music", "/synthesis_music_stream"):
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
            if route == "/synthesis_music_stream":
                self._stream(data)
            else:
                self._send_json(service.handle_synthesis(data))

        def _chunk(self, b: bytes):
            self.wfile.write(b"%X\r\n%s\r\n" % (len(b), b))

        def _stream(self, data: dict):
            """Chunked audio/wav, one HTTP chunk per decode window. The
            stream's first piece (the lead-in, after the melody) is taken
            before any byte is sent, so an error up to there answers the
            JSON contract; a later one is logged and ends the stream."""
            gen = service.stream_synthesis(data)
            if isinstance(gen, dict):
                self._send_json(gen)
                return
            try:
                first = next(gen)
            except Exception:
                service.logger.error("stream failed:\n%s",
                                     traceback.format_exc())
                self._send_json({"code": 203,
                                 "message": "服务器错误，歌声合成出错！"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            try:
                self._chunk(streaming_wav_header())
                for piece in itertools.chain([first], gen):
                    if len(piece):
                        self._chunk(piece.tobytes())
            except Exception:
                service.logger.error("stream failed mid-flight:\n%s",
                                     traceback.format_exc())
                gen.close()
            finally:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

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
    a flag combination the server cannot serve."""
    parser = argparse.ArgumentParser(
        description="music_generation_tpu_torch server (PyTorch/CUDA)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--host", default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny models (smoke testing)")
    parser.add_argument("--variant", default="svs_v6_multispeaker",
                        choices=sorted(VARIANTS),
                        help="reference server variant preset (v1: the "
                             "shell backend in front of the model path)")
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
    parser.add_argument("--fused", action="store_true",
                        help="serve a request alone in flight through the "
                             "fused path (pipeline/fused.py: one "
                             "device-to-host copy per request); concurrent "
                             "requests take the staged path and its batcher. "
                             "Ignored, with a warning, by melody_v2 and "
                             "v1_model, whose melody has no whole-song form")
    parser.add_argument("--warmup", action="store_true",
                        help="answer one song (and, with --fused, the "
                             "staged path too) before serving, so that the "
                             "first request finds its buckets warm")
    parser.add_argument("--device", default="cuda",
                        help="torch device the models run on (default cuda; "
                             "raises when no GPU is present)")
    parser.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                        help="multi-device SVS inference mesh, e.g. 4x2: "
                             "each batched call's sentences split over "
                             "`data` rows of devices, each row's large "
                             "weights split over its `model` devices")
    args = parser.parse_args(argv)
    args.mesh_grid = None
    if args.mesh is not None:
        from ..parallel import make_mesh
        try:
            n_data, n_model = (int(x) for x in args.mesh.lower().split("x"))
            args.mesh_grid = make_mesh(
                n_data, n_model,
                devices=None if args.device.startswith("cuda")
                else [args.device])
        except ValueError as e:
            parser.error(f"--mesh {args.mesh}: {e}")
    if args.nsf and args.decoder != "hifigan":
        # NSF excitation is wired into the HiFi-GAN decoder only
        parser.error("--nsf requires --decoder hifigan")
    spec = VARIANTS[args.variant]

    cfg = ServiceConfig.from_file(args.config) if args.config \
        else ServiceConfig()
    cfg = ServiceConfig.from_env(cfg)
    if spec.backend == "shell":
        cfg.backend = "shell"
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
    the checkpoint dir's weights, when the config names one; with --mesh
    each SVS model's batched calls then run over the mesh."""
    from ..pipeline.synthesis import build_svs_synthesizers
    mesh = getattr(args, "mesh_grid", None)
    songs = variant_song_synthesizer(
        VARIANTS[args.variant],
        build_svs_synthesizers(cfg.tiny, cfg.n_speakers, seed=seed,
                               device=mesh[0][0] if mesh else args.device,
                               decoder=args.decoder,
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
    if mesh:
        from ..parallel import mesh_shape
        for svs in songs.synthesizers.values():
            svs.place_on_mesh(mesh)
        logging.getLogger(cfg.log_name).info("inference mesh: %s",
                                             mesh_shape(mesh))
    return songs


def warm_up(service: MusicGenerationService) -> dict:
    """One song request of WARMUP_TEXT through the service (the fused path
    when it is on, since it is alone), then, with a fused path, the staged
    path that concurrent requests take: {"code", "request_s"[,
    "staged_s"]}, each logged."""
    t0 = time.time()
    out = service.handle_synthesis({"text": WARMUP_TEXT})
    row = {"code": out.get("code"), "request_s": time.time() - t0}
    service.logger.info("warmup request code=%s in %.3f s", row["code"],
                        row["request_s"])
    if service.fused is not None:
        t0 = time.time()
        service.songs.synthesize_song(WARMUP_TEXT)
        row["staged_s"] = time.time() - t0
        service.logger.info("staged-path warmup in %.3f s", row["staged_s"])
    return row


def build_service(args, cfg: ServiceConfig) -> MusicGenerationService:
    """The service main() serves, from configure()'s (args, cfg): the song
    pipeline (build_songs), the lyric LM, the fused path under --fused,
    the shell backend around the lyric LM (answering first when
    ``cfg.backend`` is "shell") and the --warmup request, whose outcome
    stays as ``service.warmup``."""
    logger = make_logger(cfg)
    from ..models.lyrics import build_lyric_generator
    songs = build_songs(args, cfg)
    lyrics = build_lyric_generator(args.lyric_model, tiny=cfg.tiny,
                                   device=args.device)
    fused = None
    if args.fused:
        if hasattr(songs.melody, "song_tensors"):
            from ..pipeline.fused import FusedSongSynthesizer
            fused = FusedSongSynthesizer(
                songs.melody, songs.synthesizers,
                lyric_replacements=songs.lyric_replacements)
            logger.info("fused path on (a request alone in flight)")
        else:
            logger.warning("--fused needs the transformer melody (variant "
                           "%s uses %s): ignored", args.variant,
                           type(songs.melody).__name__)
    from ..pipeline.shell_backend import ShellPipelineBackend
    service = MusicGenerationService(
        songs, lyrics, cfg, logger,
        canned_dir=VARIANTS[args.variant].canned_dir,
        fused_synthesizer=fused,
        shell_backend=ShellPipelineBackend(lyric_fn=lyrics.generate))
    if args.warmup:
        service.warmup = warm_up(service)
    return service


def main(argv=None):
    args, cfg = configure(argv)
    logger = make_logger(cfg)
    logger.info("loading models (variant=%s, backend=%s, decoder=%s, nsf=%s, "
                "f0=%s, f0_residual=%s, decoder_bf16=%s, tiny=%s, lyric "
                "model=%s, fused=%s, device=%s)...", args.variant,
                cfg.backend, args.decoder, args.nsf, args.f0,
                args.f0_residual, args.decoder_bf16, cfg.tiny,
                args.lyric_model, args.fused, args.device)
    import torch
    # full float32, the precision the port is held to against the JAX
    # package (cuDNN would otherwise run the convolutions in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    service = build_service(args, cfg)
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
