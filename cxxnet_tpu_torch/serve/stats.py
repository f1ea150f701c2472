"""Streaming serving telemetry: latency quantiles, throughput, batch
occupancy, shed/timeout counters — the numbers behind ``/metrics``.

Conventions follow the training-side observability modules: the
quantile machinery is ``metrics.StreamingQuantile`` (bounded recency
window, exact over the window) and the latency philosophy matches
``profiler.StepTimer`` — host wall clock including queueing, which is
what a caller experiences, not just device time.

Occupancy is reported two ways because they answer different
questions:

* ``batch_occupancy`` — mean REQUESTS coalesced per dispatch. > 1
  means the dynamic batcher is actually merging traffic (the number
  the acceptance check watches).
* ``batch_fill`` — mean fraction of the DISPATCHED bucket's rows
  carrying real data. Low fill with high occupancy says requests are
  tiny; high fill says the chosen bucket matches the traffic. The
  denominator is the bucket each dispatch actually ran.

``bucket_dispatches`` counts dispatches per bucket size (a live
trainer serves one bucket, its batch size).

All counters are totals since construction; latency percentiles are
over the last ``window`` completed requests. Thread-safe (one lock —
the dispatch thread and every HTTP handler thread report here).

The port's copy of ``cxxnet_tpu/serve/stats.py``, without the obs
registry projection and the decode counters (the obs seams and the
decoders come later, ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from ..metrics import StreamingQuantile


class ServeStats:
    def __init__(self, window: int = 1024) -> None:
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._lat = StreamingQuantile(window)
        self._lat_sum = 0.0
        self.requests = 0        # completed successfully
        self.rows = 0            # rows in completed requests
        self.dispatches = 0
        self.dispatched_requests = 0
        self.rejected = 0        # shed at admission (queue full)
        self.timeouts = 0        # expired before / while dispatching
        self.errors = 0          # failed inside the callee
        self.drained = 0         # failed by a drain window expiring
        self._fill_sum = 0.0
        self.bucket_dispatches: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def on_timeout(self, n: int = 1) -> None:
        with self._lock:
            self.timeouts += n

    def on_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def on_drained(self, n: int = 1) -> None:
        with self._lock:
            self.drained += n

    def on_dispatch(self, nreq: int, rows: int, capacity: int) -> None:
        """One callee invocation coalescing ``nreq`` requests totalling
        ``rows`` rows against a ``capacity``-row batch shape — the
        bucket the dispatch actually ran, which is also the
        ``bucket_dispatches`` histogram key."""
        with self._lock:
            self.dispatches += 1
            self.dispatched_requests += nreq
            self._fill_sum += rows / float(capacity) if capacity else 0.0
            self.bucket_dispatches[int(capacity)] = \
                self.bucket_dispatches.get(int(capacity), 0) + 1

    def on_complete(self, latency_s: float, rows: int) -> None:
        """One request answered (dispatch + result handed back)."""
        with self._lock:
            self.requests += 1
            self.rows += rows
            self._lat.add(latency_s)
            self._lat_sum += latency_s

    # ------------------------------------------------------------------
    def estimate_clear_s(self, depth: int) -> float:
        """Rough seconds for a backlog of ``depth`` queued requests to
        clear at the recent service rate: depth / occupancy dispatches
        at ~p50 latency each. Feeds the computed ``Retry-After`` — an
        estimate good to a small factor beats a hardcoded 1. With no
        completed traffic yet (empty latency window) a conservative
        50 ms per dispatch stands in."""
        if depth <= 0:
            return 0.0
        with self._lock:
            p50, = self._lat.quantiles([0.5])
            occ = (self.dispatched_requests / self.dispatches
                   if self.dispatches else 1.0)
        per = p50 if p50 == p50 and p50 > 0 else 0.05   # NaN = empty
        return depth / max(occ, 1.0) * per

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """The /metrics payload (JSON-ready)."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            p50, p90, p99 = self._lat.quantiles([0.5, 0.9, 0.99])
            n = self.requests
            return {
                "uptime_sec": elapsed,
                "requests": n,
                "rows": self.rows,
                "dispatches": self.dispatches,
                "rejected": self.rejected,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "drained": self.drained,
                "batch_occupancy": (
                    self.dispatched_requests / self.dispatches
                    if self.dispatches else 0.0),
                "batch_fill": (self._fill_sum / self.dispatches
                               if self.dispatches else 0.0),
                "bucket_dispatches": {
                    str(b): n for b, n
                    in sorted(self.bucket_dispatches.items())},
                "rows_per_sec": self.rows / elapsed,
                "requests_per_sec": n / elapsed,
                "latency_ms": {
                    "mean": 1000.0 * self._lat_sum / n if n else 0.0,
                    "p50": 1000.0 * p50 if n else 0.0,
                    "p90": 1000.0 * p90 if n else 0.0,
                    "p99": 1000.0 * p99 if n else 0.0,
                },
            }
