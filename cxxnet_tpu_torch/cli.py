"""CLI task driver: ``python -m cxxnet_tpu_torch config.conf [k=v ...]``.

The same argv contract as ``python -m cxxnet_tpu`` (a config file plus
``k=v`` overrides). This slice runs ``task = serve`` with ``model_in =
<checkpoint>``: load the net from a ``.model`` file either package
wrote, on the device ``dev`` names (CUDA unless ``dev = cpu``), and
serve it over HTTP through the dynamic-batching engine. Serve keys as in
cxxnet_tpu: serve_host (default 127.0.0.1), serve_port (default 8080; 0
binds a free port), serve_max_wait_ms (default 5), serve_max_batch
(default the batch size), serve_queue_limit (default 64),
serve_timeout_ms (default 30000), serve_dispatch_depth (default 2),
serve_warmup (default 1).

Every other task, exported artifacts (``export_in``) and the replica
router raise ``NotImplementedError`` naming the ROADMAP.md slice that
brings them.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from . import config
from .serve.engine import ServingEngine
from .serve.server import ServeHTTPServer, build_server
from .trainer import Trainer

ConfigEntry = Tuple[str, str]

_LATER_TASKS = {
    "train": "the training slice", "finetune": "the training slice",
    "pred": "the training slice", "extract": "the training slice",
    "generate": "the decode slice",
    "export_model": "the paged-serving slice (artifact export)",
    "export_reference": "the training slice",
}


class LearnTask:
    def __init__(self) -> None:
        self.cfg: List[ConfigEntry] = []
        self.task = "train"
        self.model_in = "NULL"
        self.silent = 0
        self.trainer: Optional[Trainer] = None
        self.engine: Optional[ServingEngine] = None
        self.server: Optional[ServeHTTPServer] = None

    def set_param(self, name: str, val: str) -> None:
        if val == "default":
            return
        if name == "task":
            self.task = val
        elif name == "model_in":
            self.model_in = val
        elif name == "silent":
            self.silent = int(val)
        self.cfg.append((name, val))

    def configure(self, argv: List[str]) -> None:
        """Read the config file and the ``k=v`` overrides, in order."""
        for name, val in config.parse_file(argv[0]):
            self.set_param(name, val)
        for name, val in config.parse_cli_overrides(argv[1:]):
            self.set_param(name, val)

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: <config>")
            return 0
        self.configure(argv)
        self.init()
        if not self.silent:
            print("initializing end, start working")
        self.task_serve()
        return 0

    def init(self) -> None:
        """Check the task is one this slice runs, then load the model."""
        if self.task != "serve":
            raise NotImplementedError(
                "task=%s is not ported yet: it comes with %s (ROADMAP.md)"
                % (self.task, _LATER_TASKS.get(self.task, "a later slice")))
        d = dict(self.cfg)
        if "export_in" in d:
            raise NotImplementedError(
                "task=serve export_in=...: exported artifacts come with the "
                "paged-serving slice (ROADMAP.md); serve a checkpoint with "
                "model_in=<file.model>")
        if int(d.get("serve_replicas", "1")) > 1:
            raise NotImplementedError(
                "serve_replicas > 1 (the replica router) comes with the "
                "paged-serving slice (ROADMAP.md)")
        if self.model_in == "NULL":
            raise RuntimeError("task=serve needs model_in=<ckpt>")
        self.trainer = Trainer()
        for k, v in self.cfg:
            self.trainer.set_param(k, v)
        self.trainer.load_model(self.model_in)

    def start_serving(self) -> ServeHTTPServer:
        """Build the engine (warming it up) and bind the HTTP server;
        ``task_serve`` then blocks in ``serve_forever``."""
        d = dict(self.cfg)
        timeout_ms = float(d.get("serve_timeout_ms", "30000"))
        self.engine = ServingEngine(
            self.trainer,
            max_wait_ms=float(d.get("serve_max_wait_ms", "5")),
            max_batch=int(d.get("serve_max_batch", "0")) or None,
            queue_limit=int(d.get("serve_queue_limit", "64")),
            timeout_ms=timeout_ms,
            dispatch_depth=int(d.get("serve_dispatch_depth", "2")),
            warmup=bool(int(d.get("serve_warmup", "1"))))
        self.server = build_server(
            self.engine, d.get("serve_host", "127.0.0.1"),
            int(d.get("serve_port", "8080")),
            # 0 disables the deadline engine-side; the handler's wait
            # must then be unbounded too, not an instant 504
            request_timeout=(timeout_ms / 1000.0 if timeout_ms > 0
                             else None),
            verbose=not self.silent)
        if not self.silent:
            host, port = self.server.server_address[:2]
            print("serving %s on http://%s:%d (device %s, batch %d, "
                  "max_wait %gms, queue %d, dispatch_depth %d)"
                  % (self.engine.kind, host, port, self.trainer.device,
                     self.engine.batch, 1000.0 * self.engine.max_wait,
                     self.engine.queue_limit, self.engine.dispatch_depth))
            sys.stdout.flush()
        return self.server

    def close(self) -> None:
        """Unbind the server and close the engine (idempotent)."""
        if self.server is not None:
            self.server.server_close()
            self.server = None
        if self.engine is not None:
            self.engine.close()
            self.engine = None

    def task_serve(self) -> None:
        srv = self.start_serving()
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()


def main(argv: Optional[List[str]] = None) -> int:
    return LearnTask().run(sys.argv[1:] if argv is None else argv)
