"""Streaming statistics for serving telemetry — the port's copy of
``cxxnet_tpu.metrics.StreamingQuantile`` (the training metrics come with
the training slice)."""

from __future__ import annotations

from typing import List

import numpy as np


class StreamingQuantile:
    """Bounded-window streaming quantile estimator (p50/p90/p99 ...).

    Keeps the most recent ``window`` observations in a ring buffer and
    answers any quantile exactly over that window via ``np.percentile``
    — O(window) memory, O(1) add, no approximation sketch. Not
    thread-safe; callers that share one instance across threads hold
    their own lock (ServeStats does)."""

    def __init__(self, window: int = 1024) -> None:
        if window < 1:
            raise ValueError("window must be >= 1, got %d" % window)
        self.window = window
        self._buf = np.empty(window, np.float64)
        self._n = 0          # observations ever seen

    def add(self, x: float) -> None:
        self._buf[self._n % self.window] = float(x)
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.window)

    def quantiles(self, qs: List[float]) -> List[float]:
        """Exact q-quantiles (0 <= q <= 1) of the retained window; nan
        when no observation has been added yet."""
        k = len(self)
        if k == 0:
            return [float("nan")] * len(qs)
        vals = np.percentile(self._buf[:k], [100.0 * q for q in qs])
        return [float(v) for v in vals]
