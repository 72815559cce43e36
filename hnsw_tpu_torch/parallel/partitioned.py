"""PartitionedGraph — the user-facing multi-device index (port of
hnsw_tpu/parallel/partitioned.py).

A k-means Partitioner routes vectors to the shards of a mesh; each shard
owns an independent HNSW sub-graph over its partition; every query
searches all partitions and a global top-k merges the gathered
per-partition candidates (parallel/sharded.partitioned_graph_search).
This is the expert-parallel analogue, with no transport code.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import GraphConfig
from hnsw_tpu_torch.core.state import DeviceGraph
from hnsw_tpu_torch.index.hnsw import Graph
from hnsw_tpu_torch.index.partitioner import Partitioner
from hnsw_tpu_torch.ops.distance import INF_DIST
from hnsw_tpu_torch.parallel.sharded import (default_mesh,
                                             partitioned_graph_search)


def _pad_graph(g: DeviceGraph, cap: int, L: int, device) -> DeviceGraph:
    """``g`` padded to ``cap`` slots and ``L`` layers on ``device``, in
    the dense layout (the optional fields are dropped)."""
    pc = cap - g.cap
    pl_ = L - g.num_layers
    F = torch.nn.functional
    return DeviceGraph(
        vectors=F.pad(g.vectors, (0, 0, 0, pc)).to(device),
        sq_norms=F.pad(g.sq_norms, (0, pc)).to(device),
        neighbors=F.pad(g.neighbors, (0, 0, 0, pc, 0, pl_),
                        value=-1).to(device),
        levels=F.pad(g.levels, (0, pc), value=-1).to(device),
        alive=F.pad(g.alive, (0, pc)).to(device),
        entry=g.entry.to(device),
    )


class PartitionedGraph:
    """One HNSW sub-graph per mesh shard, centroid-routed. Sub-graph p
    serves on the mesh's device p; ``mesh=None`` is ``default_mesh()``
    (the CUDA devices; it raises without CUDA)."""

    def __init__(self, mesh=None, config: Optional[GraphConfig] = None,
                 axis: str = "data"):
        self.mesh = mesh or default_mesh()
        self.axis = axis
        self.n_parts = self.mesh.shape[axis]
        self.cfg = config or GraphConfig()
        self.cfg.validate()
        self.partitioner = Partitioner(self.n_parts,
                                       metric=self.cfg.metric,
                                       seed=self.cfg.seed,
                                       device=self.mesh.devices[0])
        self.graphs: List[Graph] = [Graph(config=self.cfg, device=dev)
                                    for dev in self.mesh.devices]
        for g in self.graphs:
            # the stacked graphs pad/stack `neighbors` as one dense
            # [L, cap, M] tensor per partition; keep sub-graphs on the
            # dense layout
            g.split_layers = False
        self._stacked = None
        self._cap = 0
        self._dirty = True

    def __len__(self) -> int:
        return sum(len(g) for g in self.graphs)

    # -- mutation -----------------------------------------------------------
    def build(self, keys: Sequence[Hashable], vectors,
              wave: int = 1024) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        parts = self.partitioner.batch_assign(keys, vectors)
        groups: List[List[int]] = [[] for _ in range(self.n_parts)]
        for i, p in enumerate(parts):
            groups[p].append(i)
        # sub-graphs are independent: build them concurrently, one thread
        # each (the native builder runs outside the interpreter lock); each
        # is the graph a sequential build gives
        jobs = [(self.graphs[p], [keys[i] for i in idxs], vectors[idxs])
                for p, idxs in enumerate(groups) if idxs]
        if jobs:
            with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                futs = [pool.submit(g.build, ks, vs, wave=wave)
                        for g, ks, vs in jobs]
                for f in futs:
                    f.result()
        self._dirty = True

    def add(self, key: Hashable, vector) -> None:
        vector = np.asarray(vector, np.float32)
        p = self.partitioner.assign(key, vector)
        self.graphs[p].add(key, vector)
        self._dirty = True

    def delete(self, key: Hashable) -> bool:
        ok = any([g.delete(key) for g in self.graphs if key in g.slots])
        self.partitioner.remove(key)
        if ok:
            self._dirty = True
        return ok

    # -- device sync ----------------------------------------------------------
    def _sync(self):
        if not self._dirty and self._stacked is not None:
            return self._stacked, self._cap
        devs = [g.device_graph() if len(g) else None for g in self.graphs]
        live = [d for d in devs if d is not None]
        if not live:
            raise RuntimeError("all partitions empty")
        home = self.mesh.devices[0]
        cap = max(d.cap for d in live)
        L = max(d.num_layers for d in live)
        dim = live[0].dim
        M = live[0].m
        empty = DeviceGraph(
            vectors=torch.zeros((cap, dim), dtype=live[0].vectors.dtype,
                                device=home),
            sq_norms=torch.zeros((cap,), dtype=torch.float32, device=home),
            neighbors=torch.full((L, cap, M), -1, dtype=torch.int32,
                                 device=home),
            levels=torch.full((cap,), -1, dtype=torch.int32, device=home),
            alive=torch.zeros((cap,), dtype=torch.bool, device=home),
            entry=torch.tensor(-1, dtype=torch.int32, device=home),
        )
        devs = [d if d is not None else empty for d in devs]
        padded = [_pad_graph(d, cap, L, home) for d in devs]
        self._stacked = DeviceGraph(*(torch.stack(xs) for xs in
                                      zip(*(p[:6] for p in padded))))
        self._cap = cap
        self._dirty = False
        return self._stacked, self._cap

    # -- search -------------------------------------------------------------
    def batch_search(self, queries, k: int, ef: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self) == 0:
            qn = queries.shape[0]
            return ([[None] * k for _ in range(qn)],
                    np.full((qn, k), INF_DIST, np.float32))
        ef = ef if ef is not None else self.cfg.ef_search
        stacked, cap = self._sync()
        d, i = partitioned_graph_search(
            stacked, torch.from_numpy(queries), k=k, ef=ef,
            metric=self.cfg.metric, max_hops=self.cfg.max_hops,
            mesh=self.mesh, axis=self.axis)
        d = d.cpu().numpy()
        i = i.cpu().numpy()
        keys_out: List[List[Any]] = []
        for row in i:
            ks = []
            for x in row:
                if x < 0:
                    ks.append(None)
                    continue
                p, s = divmod(int(x), cap)
                ks.append(self.graphs[p].slots.key_of(s))
            keys_out.append(ks)
        return keys_out, d

    def search(self, query, k: int, ef: Optional[int] = None
               ) -> List[Tuple[Any, float]]:
        keys, d = self.batch_search(np.asarray(query, np.float32)[None],
                                    k, ef)
        return [(kk, float(dd)) for kk, dd in zip(keys[0], d[0])
                if kk is not None]

    def stats(self) -> dict:
        return {
            "partitions": self.n_parts,
            "sizes": [len(g) for g in self.graphs],
            "partitioner": self.partitioner.stats(),
        }
