"""Query telemetry (port of hnsw_tpu/telemetry.py) — parity with the
reference's per-query metrics
window (hybrid/adaptive.go:17-45, 244-313): sliding window of
QueryMetrics, per-strategy aggregates with P95, exposed as nested
dicts like GetStats (adaptive.go:436-469).

Host-side and synchronous: the reference records on a detached
goroutine (adaptive_hybrid.go:275); recording here is a few dict ops,
so we just do it inline — no async machinery to go wrong.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class DistanceStats:
    """adaptive.go:31-38."""
    min: float = 0.0
    max: float = 0.0
    mean: float = 0.0
    variance: float = 0.0

    @classmethod
    def from_distances(cls, dists) -> "DistanceStats":
        # plain-Python math: inputs are <= k floats per query and this
        # runs on EVERY recorded query — four numpy reductions on a
        # 10-element list were ~0.16 ms of the single-query hot path
        src = (dists if isinstance(dists, (list, tuple))
               else np.ravel(dists).tolist())
        vals = [float(x) for x in src if math.isfinite(x)]
        if not vals:
            return cls()
        n = len(vals)
        mean = sum(vals) / n
        var = sum((x - mean) * (x - mean) for x in vals) / n
        return cls(min=min(vals), max=max(vals), mean=mean, variance=var)


@dataclasses.dataclass
class QueryMetrics:
    """adaptive.go:17-29."""
    strategy: str
    duration_s: float
    result_count: int
    #: None = not measured (distinct from a MEASURED 0.0 — a tier that
    #: returns fully disjoint keys must be able to record it)
    recall: Optional[float] = None
    success: bool = True
    distance_stats: Optional[DistanceStats] = None
    timestamp: float = dataclasses.field(default_factory=time.time)


class StrategyStats:
    """Per-strategy aggregate with P95 over a sliding window
    (adaptive.go:274-313).

    Aggregates ride O(1) running sums maintained on record/evict — the
    selector reads avg_latency/avg_recall/success_rate for every arm on
    EVERY query, and rebuilding np.mean over the window was 40% of the
    single-query adaptive path. Sums are rebuilt from the window every
    4096 records to cap float drift."""

    def __init__(self, window_size: int = 100):
        self.window: Deque[QueryMetrics] = deque(maxlen=window_size)
        self._lat_sum = 0.0
        self._succ_sum = 0
        self._recall_sum = 0.0
        self._recall_n = 0
        self._records = 0

    def record(self, m: QueryMetrics) -> None:
        if (self.window.maxlen is not None
                and len(self.window) == self.window.maxlen):
            old = self.window[0]
            self._lat_sum -= old.duration_s
            self._succ_sum -= 1 if old.success else 0
            if old.recall is not None:
                self._recall_sum -= old.recall
                self._recall_n -= 1
        self.window.append(m)
        self._lat_sum += m.duration_s
        self._succ_sum += 1 if m.success else 0
        if m.recall is not None:
            self._recall_sum += m.recall
            self._recall_n += 1
        self._records += 1
        if self._records % 4096 == 0:
            self._rebuild()

    def _rebuild(self) -> None:
        self._lat_sum = sum(m.duration_s for m in self.window)
        self._succ_sum = sum(1 for m in self.window if m.success)
        rec = [m.recall for m in self.window if m.recall is not None]
        self._recall_sum = sum(rec)
        self._recall_n = len(rec)

    @property
    def count(self) -> int:
        return len(self.window)

    def avg_latency(self) -> float:
        if not self.window:
            return 0.0
        return self._lat_sum / len(self.window)

    def p95_latency(self) -> float:
        if not self.window:
            return 0.0
        lat = sorted(m.duration_s for m in self.window)
        idx = min(len(lat) - 1, int(0.95 * len(lat)))
        return float(lat[idx])

    def avg_recall(self) -> Optional[float]:
        """Mean over MEASURED recalls (None entries are unprobed, not
        zero); None when nothing was ever measured."""
        if not self._recall_n:
            return None
        return self._recall_sum / self._recall_n

    def success_rate(self) -> float:
        if not self.window:
            return 1.0
        return self._succ_sum / len(self.window)

    def as_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "avg_latency_s": self.avg_latency(),
            "p95_latency_s": self.p95_latency(),
            "avg_recall": self.avg_recall(),
            "success_rate": self.success_rate(),
        }


class MetricsWindow:
    """All-strategy registry (adaptive.go:244 RecordQueryMetrics)."""

    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self.by_strategy: Dict[str, StrategyStats] = {}
        self.total = 0

    def record(self, m: QueryMetrics) -> None:
        self.total += 1
        self.by_strategy.setdefault(
            m.strategy, StrategyStats(self.window_size)).record(m)

    def stats(self, strategy: str) -> Optional[StrategyStats]:
        return self.by_strategy.get(strategy)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        out = {s: st.as_dict() for s, st in self.by_strategy.items()}
        out["_total_queries"] = self.total  # type: ignore
        return out
