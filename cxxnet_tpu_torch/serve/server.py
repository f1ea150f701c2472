"""HTTP front end for :class:`~cxxnet_tpu_torch.serve.engine.ServingEngine`
— the forward endpoints of ``cxxnet_tpu/serve/server.py``, with the same
request and response bodies.

Stdlib-only (``http.server.ThreadingHTTPServer``): one handler thread
per connection blocks on its request while the engine's dispatch thread
batches across all of them. JSON in, JSON out.

Endpoints:
  POST /predict    {"data": nested list (n, *item_shape),
                    "timeout_ms": optional} ->
                   {"output": probs, "pred": task=pred convention,
                    "request_id", "timing"}
  GET  /healthz    liveness + the served contract (503 unless serving)
  GET  /metrics    engine.metrics() JSON

Error mapping: malformed body/shape -> 400, queue full -> 429 with a
computed Retry-After, draining/warming -> 503, request deadline -> 504,
forward failure -> 500. /generate, /swap, /slo, the Prometheus view and
the /debug endpoints come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import json
import math
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlsplit

import numpy as np

from .engine import DrainError, QueueFullError, ServingEngine


def _pred_convention(out: np.ndarray):
    """task=pred's answer shape: argmax per row for multi-way outputs,
    the raw scalar for 1-wide (regression) outputs."""
    mat = out.reshape(out.shape[0], -1)
    if mat.shape[1] == 1:
        return [float(v) for v in mat[:, 0]]
    return [int(v) for v in mat.argmax(axis=1)]


class ServeHandler(BaseHTTPRequestHandler):
    server_version = "cxxnet-tpu-torch-serve/0.1"
    protocol_version = "HTTP/1.1"

    _req_id: Optional[str] = None

    def log_message(self, fmt, *args):   # default spams stderr per hit
        if self.server.verbose:
            sys.stderr.write("%s - %s\n"
                             % (self.address_string(), fmt % args))

    def _send(self, code: int, obj) -> None:
        """Strict-JSON response; the current request id rides both the
        body and the X-Request-Id header. 429/503 carry Retry-After."""
        if self._req_id is not None and isinstance(obj, dict) \
                and "request_id" not in obj:
            obj = dict(obj, request_id=self._req_id)
        ra = None
        if code in (429, 503):
            ra = max(1, int(math.ceil(self.server.engine.retry_after_s())))
            obj = dict(obj, retry_after_s=ra)
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self._req_id is not None:
            self.send_header("X-Request-Id", self._req_id)
        if ra is not None:
            self.send_header("Retry-After", str(ra))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self.close_connection = True
            self._send(400, {"error": "bad Content-Length"})
            return None
        if n <= 0:
            self._send(400, {"error": "missing request body"})
            return None
        if n > self.server.max_body:
            # an unread oversize body would be parsed as the next request
            # on this keep-alive connection: close instead
            self.close_connection = True
            self._send(413, {"error": "body exceeds %d bytes"
                             % self.server.max_body})
            return None
        try:
            obj = json.loads(self.rfile.read(n))
        except ValueError:
            self._send(400, {"error": "body is not valid JSON"})
            return None
        if not isinstance(obj, dict):
            self._send(400, {"error": "body must be a JSON object"})
            return None
        return obj

    # ------------------------------------------------------------------
    def do_GET(self):
        self._req_id = None
        eng: ServingEngine = self.server.engine
        path = urlsplit(self.path).path
        if path == "/healthz":
            info = eng.healthz()
            self._send(200 if info.get("ok") else 503, info)
        elif path == "/metrics":
            self._send(200, eng.metrics())
        else:
            self._send(404, {"error": "no such path %s" % path})

    def do_POST(self):
        self._req_id = None
        if self.path == "/predict":
            self._post_predict()
        else:
            self._send(404, {"error": "no such path %s" % self.path})

    def _post_predict(self):
        eng: ServingEngine = self.server.engine
        payload = self._read_json()
        if payload is None:
            return
        state = eng.state
        if state != "serving":
            self._send(503, {"error": "not accepting requests: %s" % state,
                             "state": state})
            return
        if "data" not in payload:
            self._send(400, {"error": 'body needs a "data" field'})
            return
        timeout_ms = None
        if "timeout_ms" in payload:
            try:
                timeout_ms = float(payload["timeout_ms"])
            except (TypeError, ValueError):
                self._send(400, {"error": "timeout_ms must be a number"})
                return
        try:
            req = eng.submit(np.asarray(payload["data"]),
                             timeout_ms=timeout_ms)
        except QueueFullError as e:
            self._send(429, {"error": str(e)})
            return
        except DrainError as e:
            self._send(503, {"error": str(e), "state": "draining"})
            return
        except (ValueError, TypeError) as e:
            self._send(400, {"error": str(e)})
            return
        self._req_id = req.id
        try:
            out = req.result(self.server.request_timeout)
        except TimeoutError as e:
            self._send(504, {"error": str(e)})
            return
        except DrainError as e:
            self._send(503, {"error": str(e)})
            return
        except Exception as e:
            self._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
            return
        self._send(200, {"output": out.tolist(),
                         "pred": _pred_convention(out),
                         "request_id": req.id,
                         "timing": req.timing()})


class ServeHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one engine. ``port=0`` binds a free
    port (read it back from ``server_address[1]``)."""
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8080,
                 request_timeout: Optional[float] = 30.0,
                 max_body: int = 64 << 20, verbose: bool = False):
        self.engine = engine
        self.request_timeout = request_timeout
        self.max_body = max_body
        self.verbose = verbose
        super().__init__((host, port), ServeHandler)

    def start_background(self) -> threading.Thread:
        """serve_forever on a daemon thread (tests, chip_smoke.py)."""
        t = threading.Thread(target=self.serve_forever,
                             name="serve-http", daemon=True)
        t.start()
        return t


def build_server(engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8080, **kw) -> ServeHTTPServer:
    return ServeHTTPServer(engine, host, port, **kw)
