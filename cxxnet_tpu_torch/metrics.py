"""Evaluation metrics and streaming statistics — the port's copy of the
host half of ``cxxnet_tpu/metrics.py`` (reference:
src/utils/metric.h:20-236).

Metrics run on host arrays (numpy) copied off the device, like the
reference's CPU metric path, and print the reference's
``\\tname-metric:value`` format. ``StreamingQuantile`` serves the serving
telemetry (serve/stats.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np


class Metric:
    name = "?"

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self.sum_metric = 0.0
        self.cnt_inst = 0

    def add_eval(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred: (n, k) scores; label: (n, w) label field."""
        for i in range(pred.shape[0]):
            self.sum_metric += self._calc(pred[i], label[i])
            self.cnt_inst += 1

    def get(self) -> float:
        if not self.cnt_inst:
            return float("nan")
        return self.sum_metric / self.cnt_inst

    def _calc(self, pred: np.ndarray, label: np.ndarray) -> float:
        raise NotImplementedError


class MetricRMSE(Metric):
    """Summed squared error per instance (reference: metric.h:73-89 —
    despite the name it accumulates squared error without the root)."""
    name = "rmse"

    def add_eval(self, pred, label):
        if pred.shape[1] != label.shape[1]:
            raise ValueError("RMSE: size of prediction and label must match")
        self.sum_metric += float(((pred - label) ** 2).sum())
        self.cnt_inst += pred.shape[0]


class MetricError(Metric):
    """argmax != label (reference: metric.h:92-110); for 1-col predictions,
    thresholds at 0."""
    name = "error"

    def add_eval(self, pred, label):
        if pred.shape[1] != 1:
            maxidx = pred.argmax(axis=1)
        else:
            maxidx = (pred[:, 0] > 0.0).astype(np.int64)
        wrong = maxidx != label[:, 0].astype(np.int64)
        self.sum_metric += float(wrong.sum())
        self.cnt_inst += pred.shape[0]


class MetricLogloss(Metric):
    """-log p[target], clipped to [1e-15, 1-1e-15] (reference:
    metric.h:113-132)."""
    name = "logloss"

    def add_eval(self, pred, label):
        n = pred.shape[0]
        if pred.shape[1] != 1:
            tgt = label[:, 0].astype(np.int64)
            py = pred[np.arange(n), tgt]
            py = np.clip(py, 1e-15, 1.0 - 1e-15)
            self.sum_metric += float(-np.log(py).sum())
        else:
            py = np.clip(pred[:, 0], 1e-15, 1.0 - 1e-15)
            y = label[:, 0]
            res = -(y * np.log(py) + (1.0 - y) * np.log(1.0 - py))
            if np.isnan(res).any():
                raise ValueError("NaN detected!")
            self.sum_metric += float(res.sum())
        self.cnt_inst += n


class MetricRecall(Metric):
    """rec@n (reference: metric.h:135-172)."""

    def __init__(self, name: str) -> None:
        m = re.match(r"rec@(\d+)", name)
        if not m:
            raise ValueError("must specify n for rec@n")
        self.topn = int(m.group(1))
        self.name = name
        super().__init__()

    def _calc(self, pred, label):
        if pred.shape[0] < self.topn:
            raise ValueError(
                "rec@%d meaningless for list of %d"
                % (self.topn, pred.shape[0]))
        top = np.argsort(-pred, kind="stable")[: self.topn]
        hit = sum(1 for lab in label if lab in top)
        return float(hit) / label.shape[0]


def create_metric(name: str) -> Optional[Metric]:
    if name == "rmse":
        return MetricRMSE()
    if name == "error":
        return MetricError()
    if name == "logloss":
        return MetricLogloss()
    if name.startswith("rec@"):
        return MetricRecall(name)
    return None


class MetricSet:
    """Set of metrics with per-metric label fields
    (reference: metric.h:175-236)."""

    def __init__(self) -> None:
        self.evals: List[Metric] = []
        self.label_fields: List[str] = []

    def add_metric(self, name: str, field: str = "label") -> None:
        if name == "token_error":
            raise NotImplementedError(
                "metric token_error comes with the transformer slice "
                "(ROADMAP.md)")
        m = create_metric(name)
        if m is None:
            raise ValueError("Metric: unknown metric name: %s" % name)
        self.evals.append(m)
        self.label_fields.append(field)

    def clear(self) -> None:
        for m in self.evals:
            m.clear()

    def add_eval(self, predscores: List[np.ndarray],
                 labels: Dict[str, np.ndarray]) -> None:
        if len(predscores) != len(self.evals):
            raise ValueError("Metric: #scores must equal #metrics")
        for m, field, pred in zip(self.evals, self.label_fields, predscores):
            if field not in labels:
                raise ValueError("Metric: unknown target = %s" % field)
            m.add_eval(pred, labels[field])

    def print(self, evname: str) -> str:
        out = []
        for m, field in zip(self.evals, self.label_fields):
            tag = "%s-%s" % (evname, m.name)
            if field != "label":
                tag += "[%s]" % field
            out.append("\t%s:%g" % (tag, m.get()))
        return "".join(out)


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
