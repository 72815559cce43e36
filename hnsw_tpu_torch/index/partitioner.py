"""Centroid partitioner (port of hnsw_tpu/index/partitioner.py) —
capability parity with hybrid/partitioner.go.

K-means-flavored routing: random unit centroids (seed 42 like the
reference, partitioner.go:52 — with its squared-norm bug fixed),
nearest-centroid assignment as one matmul at HIGHEST (full f32) on the
partitioner's device, mean-update, and full rebalance.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core.state import default_device
from hnsw_tpu_torch.ops.distance import pairwise_dist


class Partitioner:
    def __init__(self, num_partitions: int, dim: Optional[int] = None,
                 metric: str = "cosine", seed: int = 42, device=None):
        if num_partitions <= 0:
            raise ValueError("num_partitions must be > 0")
        self.metric = canonical_metric(metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.num_partitions = num_partitions
        self.seed = seed
        self.dim = dim
        self.centroids: Optional[np.ndarray] = None
        self.members: List[set] = [set() for _ in range(num_partitions)]
        self.assignment: Dict[Hashable, int] = {}
        self._vectors: Dict[Hashable, np.ndarray] = {}
        if dim is not None:
            self._init_centroids(dim)

    def _init_centroids(self, dim: int) -> None:
        rng = np.random.default_rng(self.seed)
        c = rng.standard_normal((self.num_partitions, dim)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True) + 1e-30
        self.centroids = c
        self.dim = dim

    def assign(self, key: Hashable, vector) -> int:
        """Nearest-centroid assignment (partitioner.go:83)."""
        return self.batch_assign([key], np.asarray(vector, np.float32)[None])[0]

    def batch_assign(self, keys: Sequence[Hashable], vectors) -> List[int]:
        vectors = np.atleast_2d(np.ascontiguousarray(vectors, np.float32))
        if self.centroids is None:
            self._init_centroids(vectors.shape[1])
        d = pairwise_dist(torch.from_numpy(vectors).to(self.device),
                          torch.from_numpy(self.centroids).to(self.device),
                          metric=self.metric).cpu().numpy()
        parts = np.argmin(d, axis=1)
        for k, v, p in zip(keys, vectors, parts):
            p = int(p)
            old = self.assignment.get(k)
            if old is not None:
                self.members[old].discard(k)
            self.assignment[k] = p
            self.members[p].add(k)
            self._vectors[k] = v
        return [int(p) for p in parts]

    def remove(self, key: Hashable) -> bool:
        p = self.assignment.pop(key, None)
        if p is None:
            return False
        self.members[p].discard(key)
        self._vectors.pop(key, None)
        return True

    def update_centroids(self) -> None:
        """Mean of members (partitioner.go:163)."""
        for p in range(self.num_partitions):
            if self.members[p]:
                vs = np.stack([self._vectors[k] for k in self.members[p]])
                self.centroids[p] = vs.mean(axis=0)

    def rebalance(self) -> int:
        """Reassign everything to the nearest (updated) centroid
        (partitioner.go:210). Returns the number of moved keys."""
        self.update_centroids()
        keys = list(self.assignment.keys())
        if not keys:
            return 0
        vecs = np.stack([self._vectors[k] for k in keys])
        old = [self.assignment[k] for k in keys]
        self.members = [set() for _ in range(self.num_partitions)]
        self.assignment = {}
        new = self.batch_assign(keys, vecs)
        return int(sum(1 for a, b in zip(old, new) if a != b))

    def partition_sizes(self) -> List[int]:
        return [len(m) for m in self.members]

    def stats(self) -> Dict[str, object]:
        sizes = self.partition_sizes()
        return {
            "num_partitions": self.num_partitions,
            "sizes": sizes,
            "total": int(sum(sizes)),
            "max": int(max(sizes)) if sizes else 0,
            "min": int(min(sizes)) if sizes else 0,
        }
