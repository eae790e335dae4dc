"""Long-running codec service.

Production/serving form of the codec: a process that pays JIT compile
cost once and then serves compress/decompress over HTTP with warm
kernels (the CLI pays Python+JAX startup per invocation; the reference
binary had no serving story at all — SURVEY.md §2).

    python -m mhc.serve --port 8750 &
    curl -s --data-binary @file http://127.0.0.1:8750/compress?mode=markov > file.mhc
    curl -s --data-binary @file.mhc http://127.0.0.1:8750/decompress > file.out
    curl -s http://127.0.0.1:8750/stats

Device work is serialized with a lock (one device); request handling and
IO overlap via threads. `start()` runs the server in a thread of the
calling process (one process keeps the device).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import api


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.errors = 0
        self.codec_seconds = 0.0
        self.codec_bytes = 0


STATE = _State()


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, code: int, body: bytes,
               ctype: str = "application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if urlparse(self.path).path == "/stats":
            up = time.time() - STATE.started
            self._reply(200, json.dumps({
                "uptime_s": round(up, 1),
                "requests": STATE.requests,
                "bytes_in": STATE.bytes_in,
                "bytes_out": STATE.bytes_out,
                "errors": STATE.errors,
                "codec_seconds": round(STATE.codec_seconds, 3),
                "codec_MBps": round(
                    STATE.codec_bytes / STATE.codec_seconds / 1e6, 2)
                if STATE.codec_seconds else None,
            }).encode(), "application/json")
        elif urlparse(self.path).path == "/healthz":
            self._reply(200, b"ok", "text/plain")
        else:
            self._reply(404, b"not found", "text/plain")

    def do_POST(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n)
        STATE.requests += 1
        STATE.bytes_in += len(data)
        t0 = time.perf_counter()
        try:
            if url.path == "/compress":
                mode = q.get("mode", ["markov"])[0]
                block_size = int(q.get("block_size", [api.DEFAULT_BLOCK_SIZE])[0])
                with STATE.lock:
                    out = api.compress(data, mode=mode, block_size=block_size)
            elif url.path == "/decompress":
                # decode method defaults to the platform rule
                # (config.decode_method); ?method= overrides
                method = q.get("method", [None])[0]
                with STATE.lock:
                    out = api.decompress(data, decode_method=method)
            else:
                self._reply(404, b"not found", "text/plain")
                return
        except ValueError as e:
            STATE.errors += 1
            self._reply(400, str(e).encode(), "text/plain")
            return
        dt = time.perf_counter() - t0
        codec_bytes = max(len(data), len(out))  # uncompressed side
        STATE.bytes_out += len(out)
        STATE.codec_seconds += dt
        STATE.codec_bytes += codec_bytes
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(out)))
        self.send_header("X-MHC-Seconds", f"{dt:.4f}")
        self.send_header("X-MHC-MBps", f"{codec_bytes / dt / 1e6:.2f}")
        self.end_headers()
        self.wfile.write(out)


def warmup(block_size: int = api.DEFAULT_BLOCK_SIZE) -> None:
    """Compile the hot paths before accepting traffic."""
    import numpy as np
    rng = np.random.default_rng(0)
    seed_data = rng.integers(0, 64, 4 * block_size, dtype=np.uint8).tobytes()
    for mode in ("markov", "huffman"):
        api.decompress(api.compress(seed_data, mode=mode,
                                    block_size=block_size))


def start(host: str = "127.0.0.1", port: int = 0):
    """Serve from a daemon thread of THIS process (the device stays with
    one process). Returns (server, base_url); call server.shutdown()."""
    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://{host}:{srv.server_port}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mhc-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--no-warmup", action="store_true")
    args = p.parse_args(argv)
    if not args.no_warmup:
        t0 = time.time()
        warmup()
        print(f"warmup done in {time.time() - t0:.1f}s", flush=True)
    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"mhc-serve listening on {args.host}:{args.port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
