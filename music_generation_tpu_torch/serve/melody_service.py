"""Standalone melody-only microservice.

Twin of music_generation_tpu/serve/melody_service.py. Parity:
Melody/flask_server.py:25-47 — GET /?lyrics=... ->
{"lyrics": ..., "durations": [...], "pitch": [...]} on :6900.

Run: python -m music_generation_tpu_torch.serve.melody_service [--tiny]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def make_melody_server(melody_generator, host: str = "0.0.0.0",
                       port: int = 6900):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            qs = parse_qs(urlparse(self.path).query)
            lyrics = (qs.get("lyrics") or [""])[0]
            if not lyrics:
                payload = {"code": 201, "message": "missing lyrics"}
            else:
                out_lyrics, notes, durations = melody_generator.generate(
                    lyrics)
                payload = {"lyrics": out_lyrics, "durations": durations,
                           "pitch": notes}
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=6900)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises when no GPU is "
                        "present)")
    args = p.parse_args(argv)

    import torch
    # full float32, as serve.app.main runs the same model
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..pipeline.synthesis import build_melody_generator
    gen = build_melody_generator(tiny=args.tiny, device=args.device)
    server = make_melody_server(gen, port=args.port)
    print(f"melody service on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
