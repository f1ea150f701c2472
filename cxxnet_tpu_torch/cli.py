"""CLI task driver: ``python -m cxxnet_tpu_torch config.conf [k=v ...]``.

The same argv contract as ``python -m cxxnet_tpu`` (a config file plus
``k=v`` overrides), on the device ``dev`` names (CUDA unless ``dev =
cpu``). Two tasks run:

* ``task = train`` (the default; reference: cxxnet_main.cpp:344-412,
  cxxnet_tpu/cli.py:594-750): ``num_round`` rounds over the ``data``
  iterator, each ended by a ``[round]\ttrain-...\t<eval>-...`` metric
  line on stderr, a checkpoint ``model_dir/%04d.model`` every
  ``save_model`` rounds; ``model_in`` starts from a checkpoint either
  package wrote (its optimizer slots included), ``continue = 1`` from the
  newest one in ``model_dir``; ``print_step`` batches between progress
  lines.
* ``task = serve`` with ``model_in = <checkpoint>``: the net served over
  HTTP through the dynamic-batching engine. Serve keys as in cxxnet_tpu:
  serve_host (default 127.0.0.1), serve_port (default 8080; 0 binds a
  free port), serve_max_wait_ms (default 5), serve_max_batch (default
  the batch size), serve_queue_limit (default 64), serve_timeout_ms
  (default 30000), serve_dispatch_depth (default 2), serve_warmup
  (default 1).

Every other task, exported artifacts (``export_in``) and the replica
router raise ``NotImplementedError`` naming the ROADMAP.md slice that
brings them.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Tuple

from . import checkpoint, config
from .io import DataIterator, create_iterator
from .serve.engine import ServingEngine
from .serve.server import ServeHTTPServer, build_server
from .trainer import Trainer

ConfigEntry = Tuple[str, str]

_LATER_TASKS = {
    "finetune": "the CNN zoo and data slice",
    "pred": "the CNN zoo and data slice",
    "extract": "the CNN zoo and data slice",
    "export_reference": "the CNN zoo and data slice",
    "generate": "the decode slice",
    "export_model": "the paged-serving slice (artifact export)",
}


class LearnTask:
    def __init__(self) -> None:
        self.cfg: List[ConfigEntry] = []
        self.task = "train"
        self.model_in = "NULL"
        self.model_dir = "models"
        self.num_round = 10
        self.max_round = 1 << 31
        self.start_counter = 0
        self.continue_training = 0
        self.save_period = 1
        self.print_step = 100
        self.silent = 0
        self.trainer: Optional[Trainer] = None
        self.itr_train: Optional[DataIterator] = None
        self.itr_evals: List[DataIterator] = []
        self.eval_names: List[str] = []
        self.engine: Optional[ServingEngine] = None
        self.server: Optional[ServeHTTPServer] = None

    def set_param(self, name: str, val: str) -> None:
        """Reference: cxxnet_main.cpp:83-105."""
        if val == "default":
            return
        if name == "task":
            self.task = val
        elif name == "model_in":
            self.model_in = val
        elif name == "model_dir":
            self.model_dir = val
        elif name == "num_round":
            self.num_round = int(val)
        elif name == "max_round":
            self.max_round = int(val)
        elif name == "start_counter":
            self.start_counter = int(val)
        elif name == "continue":
            self.continue_training = int(val)
        elif name == "save_model":
            self.save_period = int(val)
        elif name == "print_step":
            self.print_step = int(val)
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
        if self.task == "train":
            self.task_train()
        else:
            self.task_serve()
        return 0

    def _create_trainer(self) -> Trainer:
        tr = Trainer()
        for k, v in self.cfg:
            tr.set_param(k, v)
        return tr

    def init(self) -> None:
        """Check the task is one this slice runs, then build or load the
        model and the iterators (reference: cxxnet_main.cpp:108-133)."""
        if self.task == "train":
            self._init_train()
            return
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
        self.trainer = self._create_trainer()
        self.trainer.load_model(self.model_in)

    def _init_train(self) -> None:
        if self.continue_training:
            found = checkpoint.find_latest_model(self.model_dir,
                                                 self.start_counter)
            if found is None:
                raise RuntimeError(
                    "Init: cannot find models for continue training; "
                    "specify model_in instead")
            path, counter = found
            print("Init: Continue training from round %d" % counter)
            self.trainer = self._create_trainer()
            self.trainer.load_model(path)
            self.start_counter = counter + 1
        elif self.model_in == "NULL":
            self.trainer = self._create_trainer()
            self.trainer.init_model()
        else:
            self.trainer = self._create_trainer()
            self.trainer.load_model(self.model_in)
            base = os.path.basename(self.model_in).split(".")[0]
            if base.isdigit():
                self.start_counter = int(base)
            self.start_counter += 1
        self.create_iterators()

    def create_iterators(self) -> None:
        """Order-sensitive iterator sections (reference:
        cxxnet_main.cpp:214-264): data/eval ... iter=end. Global keys are
        broadcast to every iterator before init, which is how a global
        ``batch_size``/``input_shape`` reaches the pipeline."""
        flag = 0
        evname = ""
        itcfg: List[ConfigEntry] = []
        defcfg: List[ConfigEntry] = []
        pending = []
        for name, val in self.cfg:
            if name in ("data", "eval", "pred"):
                flag = {"data": 1, "eval": 2, "pred": 3}[name]
                evname = val
                continue
            if name == "iter" and val == "end":
                pending.append((flag, evname, itcfg))
                flag = 0
                itcfg = []
                continue
            if flag != 0:
                itcfg.append((name, val))
            else:
                defcfg.append((name, val))
        for flag, evname, itcfg in pending:
            if flag == 1:
                if self.itr_train is not None:
                    raise ValueError("can only have one data")
                self.itr_train = create_iterator(itcfg, defcfg)
            elif flag == 2:
                self.itr_evals.append(create_iterator(itcfg, defcfg))
                self.eval_names.append(evname)

    def save_model_file(self) -> None:
        """Reference: cxxnet_main.cpp:173-182 (cadence check + %04d
        name; the reference checks the incremented counter)."""
        counter = self.start_counter
        self.start_counter += 1
        if self.save_period == 0 or self.start_counter % self.save_period:
            return
        os.makedirs(self.model_dir, exist_ok=True)
        self.trainer.save_model(checkpoint.model_path(self.model_dir,
                                                      counter))

    def _eval_line(self) -> str:
        if not self.itr_evals:
            return self.trainer.evaluate(None, "train")
        return "".join(self.trainer.evaluate(itr, name) for itr, name
                       in zip(self.itr_evals, self.eval_names))

    def task_train(self) -> None:
        """Reference: cxxnet_main.cpp:344-412."""
        start = time.time()
        tr = self.trainer
        if self.continue_training == 0 and self.model_in == "NULL":
            self.save_model_file()
        else:
            sys.stderr.write(self._eval_line() + "\n")
            sys.stderr.flush()
        if self.itr_train is None:
            return
        rounds = self.max_round
        while self.start_counter <= self.num_round and rounds > 0:
            rounds -= 1
            if not self.silent:
                print("update round %d" % (self.start_counter - 1), end="")
                sys.stdout.flush()
            tr.start_round(self.start_counter)
            t0 = time.time()
            steps = 0
            self.itr_train.before_first()
            while self.itr_train.next():
                tr.update(self.itr_train.value)
                steps += 1
                if not self.silent and self.print_step > 0 \
                        and steps % self.print_step == 0:
                    print("\r%80s\rround %8d:[%8d] %d sec elapsed"
                          % ("", self.start_counter - 1, steps,
                             int(time.time() - start)), end="")
                    sys.stdout.flush()
            sys.stderr.write("[%d]" % self.start_counter + self._eval_line()
                             + "\n")
            sys.stderr.flush()
            if not self.silent:
                dt = time.time() - t0
                print("\nround %d: %d steps, %.1f images/s (round wall "
                      "time, metric pass included)"
                      % (self.start_counter, steps,
                         steps * tr.batch_size / max(dt, 1e-9)))
            self.save_model_file()
        if not self.silent:
            print("\nupdating end, %d sec in all" % int(time.time() - start))

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
