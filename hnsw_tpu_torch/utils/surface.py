"""Distance "surfaces" over arbitrary types (port of
hnsw_tpu/utils/surface.py) — parity with vectortypes/
(vectortypes/types.go:11-44, distance.go:56-87, vector/vector.go:24-50).

A Surface measures distance between values of any type T; ContraMap
lifts a vector surface onto T via a projection T -> vector. The
projection also powers batched scoring: project once, score with one
matmul.
"""

from __future__ import annotations

from typing import Callable, Generic, List, Sequence, Tuple, TypeVar

import numpy as np

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.ops.distance import np_pairwise_dist, point_dist

T = TypeVar("T")


class Surface(Generic[T]):
    """Distance typeclass (vectortypes/types.go:11)."""

    def distance(self, a: T, b: T) -> float:  # pragma: no cover
        raise NotImplementedError


class BasicSurface(Surface[np.ndarray]):
    """Vector surface from a metric name or callable
    (vectortypes/types.go:32 BasicSurface)."""

    def __init__(self, metric="cosine"):
        if callable(metric):
            self._fn = metric
            self.metric = None
        else:
            self.metric = canonical_metric(metric)
            self._fn = lambda a, b: point_dist(a, b, self.metric)

    def distance(self, a, b) -> float:
        return float(self._fn(np.asarray(a, np.float32),
                              np.asarray(b, np.float32)))


class ContraMap(Surface[T]):
    """Surface[T] from Surface[vector] + projection T -> vector
    (vectortypes/types.go:18 ContraMap)."""

    def __init__(self, surface: Surface[np.ndarray],
                 contra_map: Callable[[T], np.ndarray]):
        self.surface = surface
        self.contra_map = contra_map

    def distance(self, a: T, b: T) -> float:
        return self.surface.distance(self.contra_map(a),
                                     self.contra_map(b))


class VectorDistance(Generic[T]):
    """Generic distance calculator wrapper (distance.go:72
    VectorDistance)."""

    def __init__(self, surface: Surface[T]):
        self.surface = surface

    def distance(self, a: T, b: T) -> float:
        return self.surface.distance(a, b)

    def batch(self, items_a: Sequence[T], items_b: Sequence[T],
              metric: str = None) -> np.ndarray:
        """Batched [A, B] distances: project once, one matmul in place
        of per-pair calls."""
        cm = getattr(self.surface, "contra_map", None)
        base = getattr(self.surface, "surface", self.surface)
        m = getattr(base, "metric", None)
        if cm is not None and m is not None:
            va = np.stack([np.asarray(cm(x), np.float32) for x in items_a])
            vb = np.stack([np.asarray(cm(x), np.float32) for x in items_b])
            return np_pairwise_dist(va, vb, m)
        if cm is None and m is not None:
            # plain vector surface (BasicSurface with a named metric):
            # items ARE the vectors — one matmul, no per-pair loop
            va = np.stack([np.asarray(x, np.float32) for x in items_a])
            vb = np.stack([np.asarray(x, np.float32) for x in items_b])
            return np_pairwise_dist(va, vb, m)
        out = np.empty((len(items_a), len(items_b)), np.float32)
        for i, a in enumerate(items_a):
            for j, b in enumerate(items_b):
                out[i, j] = self.surface.distance(a, b)
        return out


def node_surface(metric: str = "cosine") -> ContraMap:
    """Surface over (key, vector) node tuples (distance.go:62
    NodeSurface)."""
    return ContraMap(BasicSurface(metric), lambda node: node[1])
