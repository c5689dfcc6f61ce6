"""Blocking HTTP relay :5500 -> :5005 (the reference's
proxy_5500_to_5005.py, 900 s read timeout), stdlib only.

Twin of music_generation_tpu/serve/proxy.py. Run:
    python -m music_generation_tpu_torch.serve.proxy [--port 5500]
        [--upstream http://127.0.0.1:5005]
GET /healthz answers the proxy's own health; every POST is relayed whole
to the upstream; an unreachable or failing upstream answers 504 JSON.
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

UPSTREAM = "http://127.0.0.1:5005"
TIMEOUT_S = 900


def make_proxy(upstream: str = UPSTREAM, timeout: float = TIMEOUT_S):
    """The relay's request handler class."""
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body: bytes, ctype: str):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, json.dumps({"ok": True}).encode(),
                           "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            req = urllib.request.Request(
                upstream + self.path, data=self.rfile.read(length),
                headers={"Content-Type": self.headers.get(
                    "Content-Type", "application/json")})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    status, body = resp.status, resp.read()
                    ctype = resp.headers.get("Content-Type",
                                             "application/json")
            except Exception as e:  # upstream down, failing or timed out
                status, ctype = 504, "application/json"
                body = json.dumps({"code": 504,
                                   "message": f"upstream error: {e}"}
                                  ).encode()
            self._send(status, body, ctype)

        def log_message(self, fmt, *args):
            pass

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="HTTP relay to the song server")
    p.add_argument("--port", type=int, default=5500)
    p.add_argument("--upstream", default=UPSTREAM)
    args = p.parse_args(argv)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_proxy(args.upstream))
    print(f"proxy :{args.port} -> {args.upstream}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
