"""Dynamic-batching serving engine over a live Trainer — the forward path
of ``cxxnet_tpu/serve/engine.py`` (ServingEngine, engine.py:385-1090).

Many small producers (request threads) in front of ONE consumer (the
net's forward at its batch size), with a bounded admission queue and a
single dispatch thread between them:

* ``submit`` enqueues a :class:`Request` (any row count) and returns at
  once; ``Request.result`` blocks the caller. At ``queue_limit`` pending
  requests admission raises :class:`QueueFullError` (HTTP 429).
* The dispatch thread takes the oldest request, then coalesces further
  whole requests FIFO until the batch is row-full or ``max_wait_ms``
  passes, and runs the smallest bucket that holds the rows.
* Each bucket owns a small pool of preallocated host input buffers:
  request rows are copied in place and a buffer returns to its pool
  once its batch's outputs have reached the host.
* With ``dispatch_depth >= 1`` the dispatch thread only SUBMITS the
  batch — the forward is enqueued on the device's stream and its output
  stays on the device — and hands it to a completion thread over a
  ``dispatch_depth``-bounded queue; the completion thread copies the
  output to the host (``.cpu()``, the one synchronising step), trims it
  and answers the requests, so packing batch N+1 overlaps the device
  running batch N. ``dispatch_depth = 0`` is the serial mode. Both
  threads use the device's current (default) stream, so batches run in
  dispatch order.
* Requests carry a deadline (``timeout_ms``); ``drain`` stops admission
  and fails stragglers after its window; ``close`` joins the threads.

Left out of this slice (ROADMAP.md): the obs seams (trace, attribution,
profile, lockcheck, jitcheck, shardcheck), exported-artifact and decoder
callees, the continuous-batching engine, replicas and the router.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from .stats import ServeStats


class QueueFullError(RuntimeError):
    """Admission queue at queue_limit — shed load (maps to HTTP 429)."""


class RequestExpired(TimeoutError):
    """The request's own deadline passed while it sat in the queue."""


class DrainError(RuntimeError):
    """The engine drained before this request could be answered, or
    refused it because a drain is in progress (HTTP 503)."""


_REQ_SEQ = itertools.count(1)
_REQ_SALT = "%04x" % (os.getpid() & 0xffff)


class Request:
    """One in-flight request, completed by the engine's threads; carries
    an ``id`` (echoed by the HTTP layer) and the stamps behind
    ``timing()``."""

    __slots__ = ("rows", "payload", "t_submit", "deadline",
                 "_event", "_value", "_error", "_flock",
                 "seq", "id", "t_dispatch", "t_infer", "t_done")

    def __init__(self, rows: int, payload, timeout_s: Optional[float]):
        self.rows = rows
        self.payload = payload
        self.t_submit = time.monotonic()
        self.deadline = (self.t_submit + timeout_s
                         if timeout_s and timeout_s > 0 else None)
        self.seq = next(_REQ_SEQ)
        self.id = "req-%s-%06x" % (_REQ_SALT, self.seq)
        self.t_dispatch: Optional[float] = None
        self.t_infer: Optional[float] = None
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._flock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None

    def _finish(self, value=None,
                error: Optional[BaseException] = None) -> bool:
        """First finisher wins (returns True); later calls are no-ops."""
        with self._flock:
            if self._event.is_set():
                return False
            self._value = value
            self._error = error
            self._event.set()
            return True

    def timing(self) -> dict:
        """Per-request latency breakdown in ms: queue_wait (submit →
        dispatcher pick-up), dispatch (pack + device submit), materialize
        (device wait + copy to host + trim), total."""
        def ms(a, b):
            return None if a is None or b is None \
                else round(1000.0 * (b - a), 3)
        end = self.t_done if self.t_done is not None else (
            time.monotonic() if self._event.is_set() else None)
        return {
            "queue_wait_ms": ms(self.t_submit, self.t_dispatch),
            "dispatch_ms": ms(self.t_dispatch, self.t_infer),
            "materialize_ms": ms(self.t_infer, self.t_done),
            "total_ms": ms(self.t_submit, end),
        }

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until answered; raises the forward's error, TimeoutError
        on expiry, or TimeoutError if ``timeout`` seconds pass."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not answered within %.3fs"
                               % (timeout if timeout is not None else -1))
        if self._error is not None:
            raise self._error
        return self._value


def coerce_forward(callee, data) -> np.ndarray:
    """Validate + normalize a forward payload against the callee's item
    shape (malformed bodies become HTTP 400)."""
    arr = np.asarray(data, callee.dtype)
    item = callee.item_shape
    if arr.shape == item:
        arr = arr[None]
    if arr.ndim != 1 + len(item) or tuple(arr.shape[1:]) != item:
        raise ValueError(
            "data must be (n, %s), got %s"
            % (", ".join(map(str, item)), arr.shape))
    if arr.shape[0] < 1:
        raise ValueError("empty request")
    return arr


def _pick_bucket(buckets: List[int], rows: int) -> int:
    """Smallest bucket that holds ``rows`` whole; the max bucket when
    none does (the caller then chunks)."""
    for b in buckets:
        if b >= rows:
            return b
    return buckets[-1]


def _to_host(out) -> np.ndarray:
    """Materialise a dispatch's output: the one device synchronisation."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


class _TrainerCallee:
    """A live Trainer's forward (the output node's values), served
    in-process at the trainer's batch size."""
    kind = "forward"

    def __init__(self, trainer):
        self.batch = int(trainer.batch_size)
        self.buckets = [self.batch]
        net = trainer.net
        self.item_shape = tuple(int(d) for d in net.node_shapes[0][1:])
        self.dtype = np.dtype(np.float32)
        self._tr = trainer

    def run(self, data: np.ndarray) -> np.ndarray:
        """Any row count, chunked into full batches, answered on the
        host (the oversize-request path)."""
        n, B = data.shape[0], self.batch
        outs = []
        for lo in range(0, n, B):
            chunk = data[lo:lo + B]
            if chunk.shape[0] < B:
                pad = np.zeros((B - chunk.shape[0],) + self.item_shape,
                               data.dtype)
                chunk = np.concatenate([chunk, pad])
            outs.append(_to_host(self.run_exact(chunk)))
        out = outs[0] if len(outs) == 1 else np.concatenate(outs)
        return out[:n]

    def run_exact(self, buf: np.ndarray):
        """One full batch; the output stays on the device."""
        return self._tr.forward_device(buf, [self._tr.net.out_node])[0]


class _Pending:
    """One submitted batch in flight between the dispatch thread and the
    completion thread."""

    __slots__ = ("out", "live", "rows", "bucket", "buf")

    def __init__(self, out, live, rows, bucket, buf):
        self.out = out
        self.live = live
        self.rows = rows
        self.bucket = bucket
        self.buf = buf


class ServingEngine:
    """Admission queue + dispatch thread + bucket batcher in front of a
    live Trainer's forward.

    Knobs (as in cxxnet_tpu):
      max_wait_ms     how long the batcher holds a non-full batch open
      max_batch       cap on coalesced rows per dispatch (default and
                      ceiling: the trainer's batch size)
      queue_limit     pending requests before admission sheds
      timeout_ms      per-request deadline (0 disables)
      dispatch_depth  batches in flight between the dispatch and
                      completion threads (0 = serial dispatch)
      warmup          run ``warmup()`` inside ``start()``
      start=False     leaves the dispatch thread stopped
    """

    def __init__(self, trainer, max_wait_ms: float = 5.0,
                 max_batch: Optional[int] = None, queue_limit: int = 64,
                 timeout_ms: float = 30000.0, dispatch_depth: int = 2,
                 warmup: bool = False, stats: Optional[ServeStats] = None,
                 start: bool = True):
        self.callee = _TrainerCallee(trainer)
        self.batch = self.callee.batch
        self.buckets = list(self.callee.buckets)
        self.kind = self.callee.kind
        self.max_batch = min(int(max_batch), self.batch) if max_batch \
            else self.batch
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait = max(float(max_wait_ms), 0.0) / 1000.0
        self.queue_limit = int(queue_limit)
        self.timeout_s = float(timeout_ms) / 1000.0
        self.dispatch_depth = max(int(dispatch_depth), 0)
        self.stats = stats or ServeStats()
        self._warmup_on_start = bool(warmup)
        self._warmed = False
        self.warmup_runs = 0
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._draining = False
        self._started = False
        self._live_lock = threading.Lock()
        self._live: set = set()
        self._pool = {b: deque() for b in self.buckets}
        self._inflight: Optional[queue.Queue] = (
            queue.Queue(maxsize=self.dispatch_depth)
            if self.dispatch_depth > 0 else None)
        self._thread = threading.Thread(
            target=self._loop, name="serve-dispatch", daemon=True)
        self._cthread = (threading.Thread(
            target=self._complete_loop, name="serve-complete",
            daemon=True) if self._inflight is not None else None)
        if start:
            self.start()

    # ------------------------------------------------------------------
    def start(self) -> None:
        if not self._started:
            if self._warmup_on_start:
                self.warmup()
            self._started = True
            self._thread.start()
            if self._cthread is not None:
                self._cthread.start()

    def warmup(self) -> None:
        """Pre-run every bucket once (and materialise the result) so the
        first-call costs — the kernels' build, CUDA context and library
        set-up — land here, not on a user request. Not counted in the
        serving stats."""
        for b in self.buckets:
            buf = self._get_buf(b)
            _to_host(self.callee.run_exact(buf))
            self._put_buf(b, buf)
            self.warmup_runs += 1
        self._warmed = True

    @property
    def state(self) -> str:
        """``warming``, ``serving``, ``draining`` or ``closed``; the
        HTTP layer answers 503 for anything but ``serving``."""
        if self._closed:
            return "closed"
        if self._draining:
            return "draining"
        if self._warmup_on_start and not self._warmed:
            return "warming"
        return "serving"

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def live_requests(self) -> int:
        with self._live_lock:
            return len(self._live)

    def retry_after_s(self) -> float:
        """Suggested client back-off (the Retry-After value)."""
        if self._closed or self._draining \
                or (self._warmup_on_start and not self._warmed):
            return 2.0
        est = self.stats.estimate_clear_s(self.queue_depth)
        return min(max(est, 1.0), 30.0)

    def healthz(self) -> dict:
        return {"ok": self.state == "serving", "state": self.state,
                "kind": self.kind, "batch": self.batch,
                "buckets": list(self.buckets),
                "dispatch_depth": self.dispatch_depth,
                "queue_depth": self.queue_depth}

    def metrics(self) -> dict:
        """stats snapshot + live gauges + configuration (/metrics)."""
        snap = self.stats.snapshot()
        snap["queue_depth"] = self.queue_depth
        snap["state"] = self.state
        snap["kind"] = self.kind
        snap["exported_batch"] = self.batch
        snap["buckets"] = list(self.buckets)
        snap["max_batch"] = self.max_batch
        snap["max_wait_ms"] = 1000.0 * self.max_wait
        snap["queue_limit"] = self.queue_limit
        snap["dispatch_depth"] = self.dispatch_depth
        snap["warmup_runs"] = self.warmup_runs
        return snap

    # ------------------------------------------------------------------
    def submit(self, data: np.ndarray,
               timeout_ms: Optional[float] = None) -> Request:
        """Enqueue a forward request of ``n >= 1`` rows, ``data`` of shape
        ``(n, *item_shape)`` (a bare item is one row). ``timeout_ms``
        overrides the engine deadline (0 = none)."""
        arr = coerce_forward(self.callee, data)
        timeout_s = self.timeout_s if timeout_ms is None \
            else float(timeout_ms) / 1000.0
        req = Request(arr.shape[0], arr, timeout_s)
        self._admit(req)
        return req

    def _finish_req(self, req: Request, value=None,
                    error: Optional[BaseException] = None) -> bool:
        if req._finish(value, error):
            with self._live_lock:
                self._live.discard(req)
            return True
        return False

    def _sweep_expired_locked(self) -> None:
        """Drop already-dead requests from a full admission queue (lock
        held), so a queue of expired requests does not shed live ones."""
        now = time.monotonic()
        dead = [r for r in self._q
                if r.deadline is not None and now > r.deadline]
        if not dead:
            return
        alive = [r for r in self._q
                 if r.deadline is None or now <= r.deadline]
        self._q.clear()
        self._q.extend(alive)
        for r in dead:
            self.stats.on_timeout()
            self._finish_req(r, error=RequestExpired(
                "request expired after %.0f ms in queue (swept at "
                "admission)" % (1000.0 * (now - r.t_submit))))

    def _admit(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._draining:
                raise DrainError("engine is draining — not admitting")
            if len(self._q) >= self.queue_limit:
                self._sweep_expired_locked()
            if len(self._q) >= self.queue_limit:
                self.stats.on_reject()
                raise QueueFullError(
                    "admission queue full (%d pending)" % len(self._q))
            with self._live_lock:
                self._live.add(req)
            self._q.append(req)
            self._cond.notify()

    # ------------------------------------------------------------------
    def _get_buf(self, bucket: int) -> np.ndarray:
        pool = self._pool[bucket]
        try:
            return pool.popleft()
        except IndexError:
            return np.zeros((bucket,) + self.callee.item_shape,
                            self.callee.dtype)

    def _put_buf(self, bucket: int, buf) -> None:
        self._pool[bucket].append(buf)

    def _gather(self) -> Optional[List[Request]]:
        """Take the oldest request, coalesce whole follow-ups FIFO until
        row-full or max_wait elapses. None = closed and drained."""
        with self._cond:
            while not self._q:
                if self._closed:
                    return None
                self._cond.wait(0.05)
            first = self._q.popleft()
            taken, rows = [first], first.rows
            deadline = time.monotonic() + self.max_wait
            while rows < self.max_batch:
                if self._q:
                    if rows + self._q[0].rows > self.max_batch:
                        break
                    r = self._q.popleft()
                    taken.append(r)
                    rows += r.rows
                    continue
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    break
                self._cond.wait(left)
            return taken

    def _dispatch(self, reqs: List[Request]) -> None:
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self.stats.on_timeout()
                self._finish_req(r, error=RequestExpired(
                    "request expired after %.0f ms in queue"
                    % (1000.0 * (now - r.t_submit))))
            else:
                r.t_dispatch = now
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        if rows > self.batch:
            # one oversize request (coalescing stops at max_batch): the
            # callee chunks it itself, synchronously
            bucket, buf = self.batch, None
        else:
            bucket = _pick_bucket(self.buckets, rows)
            buf = self._get_buf(bucket)
        try:
            if buf is None:
                out = self.callee.run(live[0].payload)
            else:
                lo = 0
                for r in live:
                    buf[lo:lo + r.rows] = r.payload
                    lo += r.rows
                # rows past lo keep whatever the buffer last held: the
                # forward is row-independent, so pad content is moot
                out = self.callee.run_exact(buf)
        except Exception as e:   # a failed submit fails the batch
            if buf is not None:
                self._put_buf(bucket, buf)
            self.stats.on_error(len(live))
            for r in live:
                self._finish_req(r, error=e)
            return
        t_infer = time.monotonic()
        for r in live:
            r.t_infer = t_infer
        pend = _Pending(out, live, rows, bucket, buf)
        if self._inflight is not None:
            self._inflight.put(pend)   # blocks at dispatch_depth in flight
        else:
            self._finish_batch(pend)

    def _finish_batch(self, pend: _Pending) -> None:
        """Copy the batch's output to the host, trim, answer every
        request. Runs on the completion thread (pipelined) or inline."""
        try:
            out = _to_host(pend.out)
        except Exception as e:
            # asynchronous device failures surface here, not at submit
            self.stats.on_error(len(pend.live))
            for r in pend.live:
                self._finish_req(r, error=e)
            return
        finally:
            pend.out = None
            if pend.buf is not None:
                self._put_buf(pend.bucket, pend.buf)
        self.stats.on_dispatch(len(pend.live),
                               min(pend.rows, pend.bucket), pend.bucket)
        done = time.monotonic()
        lo = 0
        for r in pend.live:
            r.t_done = done
            if self._finish_req(r, value=out[lo:lo + r.rows]):
                self.stats.on_complete(done - r.t_submit, r.rows)
            lo += r.rows

    def _loop(self) -> None:
        while True:
            reqs = self._gather()
            if reqs is None:
                if self._inflight is not None:
                    self._inflight.put(None)   # completion shutdown
                return
            self._dispatch(reqs)

    def _complete_loop(self) -> None:
        while True:
            pend = self._inflight.get()
            if pend is None:
                return
            self._finish_batch(pend)

    # ------------------------------------------------------------------
    def drain(self, timeout: float = 10.0) -> int:
        """Stop admitting (new submissions raise :class:`DrainError`),
        keep answering what was admitted, and after ``timeout`` seconds
        fail the stragglers; returns the straggler count."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + max(float(timeout), 0.0)
        while time.monotonic() < deadline:
            if self.live_requests == 0:
                return 0
            time.sleep(0.005)
        with self._live_lock:
            stragglers = list(self._live)
        n = 0
        for r in stragglers:
            if self._finish_req(r, error=DrainError(
                    "request %s unanswered after %.1fs drain window"
                    % (r.id, timeout))):
                self.stats.on_drained()
                n += 1
        with self._cond:
            self._q.clear()
        return n

    def close(self, timeout: float = 10.0) -> None:
        """Stop admission, finish what is queued and in flight, join the
        threads; anything still pending afterwards fails."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._started:
            self._thread.join(timeout)
            if self._cthread is not None:
                self._cthread.join(timeout)
        with self._cond:
            while self._q:
                self._finish_req(self._q.popleft(),
                                 error=RuntimeError("engine closed"))

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
