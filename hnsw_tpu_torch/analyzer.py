"""Graph introspection & quality metrics (copy of hnsw_tpu/analyzer.py;
it reads the host graph arrays only) — parity with analyzer.go.

Array layout makes most of these free reductions:
  height        -> analyzer.go:16
  connectivity  -> analyzer.go:22  (mean edges per node per layer)
  topography    -> analyzer.go:41  (node count per layer)
  quality_metrics -> analyzer.go:51-90 (node count, avg/std connectivity,
  distortion ratio via BFS hops over sampled pairs, layer balance vs the
  ideal Ml^i geometric decay, height)
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List

import numpy as np


@dataclasses.dataclass
class QualityMetrics:
    """analyzer.go:51-67."""
    node_count: int
    avg_connectivity: float
    connectivity_std_dev: float
    distortion_ratio: float
    layer_balance: float
    graph_height: int


class Analyzer:
    """analyzer.go:12 — reads the graph's structure."""

    def __init__(self, graph):
        self.graph = graph

    def _host(self):
        return self.graph.host

    def height(self) -> int:
        return self._host().top + 1 if self._host().top >= 0 else 0

    def topography(self) -> List[int]:
        h = self._host()
        levels = h.levels[h.levels >= 0]
        return [int((levels >= l).sum()) for l in range(self.height())]

    def connectivity(self) -> List[float]:
        """Mean out-degree per layer (analyzer.go:22)."""
        h = self._host()
        out = []
        for l in range(self.height()):
            members = np.nonzero(h.levels >= l)[0]
            if len(members) == 0:
                out.append(0.0)
                continue
            deg = (h.neighbors[l][members] >= 0).sum(axis=1)
            out.append(float(deg.mean()))
        return out

    def _bfs_hops(self, layer: int, src: int, dst: int,
                  max_depth: int = 10) -> int:
        """Hop distance on a layer, depth-capped (analyzer.go:135-240)."""
        h = self._host()
        if src == dst:
            return 0
        seen = {src}
        frontier = deque([(src, 0)])
        while frontier:
            node, depth = frontier.popleft()
            if depth >= max_depth:
                continue
            row = h.neighbors[layer, node]
            for nb in row[row >= 0]:
                nb = int(nb)
                if nb == dst:
                    return depth + 1
                if nb not in seen:
                    seen.add(nb)
                    frontier.append((nb, depth + 1))
        return -1

    def quality_metrics(self, sample: int = 100,
                        seed: int = 0) -> QualityMetrics:
        h = self._host()
        alive = np.nonzero(h.levels >= 0)[0]
        n = len(alive)
        if n == 0:
            return QualityMetrics(0, 0.0, 0.0, 0.0, 1.0, 0)

        deg = (h.neighbors[0][alive] >= 0).sum(axis=1).astype(np.float64)
        avg_conn = float(deg.mean())
        std_conn = float(deg.std())

        # Distortion: BFS hop distance / metric distance over sampled
        # pairs (analyzer.go:135+: <=100 sampled nodes, depth cap 10).
        rng = np.random.default_rng(seed)
        m = min(sample, n)
        picks = rng.choice(alive, size=m, replace=False)
        ratios = []
        for i in range(0, len(picks) - 1, 2):
            a, b = int(picks[i]), int(picks[i + 1])
            hops = self._bfs_hops(0, a, b)
            if hops <= 0:
                continue
            dist = h._dist_one(h.store.vectors[a], b)
            if dist > 1e-9:
                ratios.append(hops / dist)
        distortion = float(np.mean(ratios)) if ratios else 0.0

        # Layer balance vs ideal geometric decay Ml^i (analyzer.go:245-279).
        topo = self.topography()
        ml = self.graph.cfg.ml
        if len(topo) <= 1 or topo[0] == 0:
            balance = 1.0
        else:
            devs = []
            for i in range(1, len(topo)):
                ideal = topo[0] * (ml ** i)
                if ideal > 0:
                    devs.append(abs(topo[i] - ideal) / max(ideal, 1.0))
            balance = float(max(0.0, 1.0 - np.mean(devs))) if devs else 1.0

        return QualityMetrics(
            node_count=n,
            avg_connectivity=avg_conn,
            connectivity_std_dev=std_conn,
            distortion_ratio=distortion,
            layer_balance=balance,
            graph_height=self.height(),
        )
