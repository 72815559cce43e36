"""ONE graph, layer-0 rows sharded over a mesh (port of
hnsw_tpu/parallel/rowsharded.py).

Query-sharding replicates the whole graph on every device and partition-
sharding builds S independent sub-graphs; neither serves a SINGLE graph
larger than one device's memory. Row-sharding does: the layer-0 neighbor
table and the vector rows are split row-wise over the mesh, the (small)
pivot entry table is replicated, and every hop exchanges the frontier.

Every shard runs the same lockstep beam over ALL queries; what is
sharded is the memory-bound part, the neighbor-row and candidate-vector
gathers. Exactly one shard owns a row, so the exchange is an owner-masked
contribution and a ``psum`` (neighbor ids [B, E*M] and candidate
distances [B, E*M]), never the gathered [B, E*M, D] vectors. Distances
are computed by the owning shard at HIGHEST precision against its f32
(or fp16, upcast) rows and summed exactly once.

Two forms of the exchange, one result:

  * shard loop (shards on several devices): each shard gathers and
    scores with its own rows under the owner mask, and the contributions
    are summed on the first device;
  * stacked (every shard on one device): the owner-masked sum over the
    shard axis of a stacked [S, n_local, ...] view has exactly one
    non-zero term, and adding zeros is exact, so the sum is the owner's
    row itself: one owner-indexed gather over the stacked rows, which
    costs what a single-device hop costs.

Both give bit-equal ids and distances (tests/test_torch_sharded.py).

Contract with single-device search (F2): the JAX docstring claims
bit-for-bit parity with the single-device pivot-seeded search on the same
graph, while its test asserts id overlap >= 0.9 (tests/test_sharded.py).
The port asserts that bound too (tests/test_torch_sharded.py, where the
overlap measures 1.0 at 4,096 x 64 in both packages); the card's smoke
measures it at 100,000 x 128. The two searches score in different
layouts (a cosine DeviceGraph holds unit rows, the shards the raw rows;
the seed distances come from the pivot product), so a near tie may
steer a hop another way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core.search import _EXP_BIT, _bitonic_merge
from hnsw_tpu_torch.ops.distance import (HIGHEST, INF_DIST, gathered_dist,
                                         pairwise_dist)
from hnsw_tpu_torch.ops.topk import topk_smallest
from hnsw_tpu_torch.parallel.sharded import Mesh, _psum, _shards

_INF = float(INF_DIST)


class RowShards(NamedTuple):
    """Host-prepared tensors of the row-sharded single graph.

    Rows are padded so that cap divides the mesh size; pad rows carry
    nbr0 = -1 and are never referenced (neighbor ids only point at real
    rows), so they need no validity mask.
    """
    nbr0: torch.Tensor        # [cap_pad, M0] int32 GLOBAL ids, -1 empty
    vectors: torch.Tensor     # [cap_pad, D] f32 / fp16 rows
    sq_norms: torch.Tensor    # [cap_pad] f32
    pivot_ids: torch.Tensor   # [Pv] int32 global slot ids (replicated)
    pivot_vecs: torch.Tensor  # [Pv, D] f32 (replicated)
    pivot_sq: torch.Tensor    # [Pv] f32


def make_row_shards(g, n_shards: int,
                    dtype: Optional[str] = None) -> RowShards:
    """Slice a built Graph's layer-0 state into mesh-ready tensors on the
    graph's device.

    ``dtype="float16"`` stores shard rows in fp16 (the capacity mode;
    scoring upcasts to f32, as hbm_mode="float16" does). Dead nodes are
    prefolded: edges to them become -1 (the tombstone prefold
    state.from_host does). Reads the graph's host arrays
    (``g.host.neighbors``), slot map, host store and pivot table
    (``g._pivot_arrays()``).
    """
    host = g.host
    used = g.slots.capacity_used
    nbr0 = np.array(host.neighbors[0][:used], np.int32)
    alive = g.store.alive[:used]
    ok = (nbr0 >= 0) & alive[np.clip(nbr0, 0, used - 1)]
    nbr0 = np.where(ok, nbr0, -1)
    vecs = np.asarray(g.store.vectors[:used], np.float32)
    sq = np.asarray(g.store.sq_norms[:used], np.float32)
    cap_pad = -(-used // n_shards) * n_shards
    pad = cap_pad - used
    if pad:
        nbr0 = np.pad(nbr0, ((0, pad), (0, 0)), constant_values=-1)
        vecs = np.pad(vecs, ((0, pad), (0, 0)))
        sq = np.pad(sq, (0, pad))
    pids, pvecs, psq = g._pivot_arrays()
    if dtype == "float16":
        vecs = vecs.astype(np.float16)
    dev = g.device
    return RowShards(torch.from_numpy(nbr0).to(dev),
                     torch.from_numpy(vecs).to(dev),
                     torch.from_numpy(sq).to(dev), pids, pvecs, psq)


class _StackedRows:
    """The exchange when every shard sits on one device: owner-indexed
    gathers over the stacked [S, n_local, ...] rows."""

    def __init__(self, shards: RowShards, mesh: Mesh, axis: str):
        dev = mesh.devices[0]
        S = mesh.shape[axis]
        self.n_local = shards.nbr0.shape[0] // S
        self.nbr0 = shards.nbr0.to(dev).reshape(S, self.n_local, -1)
        self.vecs = shards.vectors.to(dev).reshape(S, self.n_local, -1)
        self.sq = shards.sq_norms.to(dev).reshape(S, self.n_local)
        self.device = dev

    def _owner(self, ids):
        owner = torch.div(ids, self.n_local, rounding_mode="floor").long()
        return owner, ids.long() - owner * self.n_local

    def gather(self, ids, take):
        """Neighbor rows [B, E, M] of a [B, E] frontier, -1 where not
        taken."""
        owner, loc = self._owner(ids)
        r = self.nbr0[owner, loc]
        return torch.where(take[:, :, None], r, -1)

    def score(self, q, q_sq, cand, ok, metric):
        """Exact distances [B, C] of candidate ids, INF where not ok."""
        owner, loc = self._owner(cand)
        cv = self.vecs[owner, loc].to(torch.float32)
        d = gathered_dist(q, cv, self.sq[owner, loc], q_sq, metric=metric,
                          precision=HIGHEST)
        return torch.where(ok, d, _INF)


class _ShardLoopRows:
    """The exchange over shards on any devices: each shard gathers and
    scores its own rows under the owner mask; the contributions are summed
    on the first device (the psum)."""

    def __init__(self, shards: RowShards, mesh: Mesh, axis: str):
        self.devices = mesh.devices
        self.device = mesh.devices[0]
        self.n_local = shards.nbr0.shape[0] // mesh.shape[axis]
        self.nbr0 = _shards(shards.nbr0, mesh, axis)
        self.vecs = _shards(shards.vectors, mesh, axis)
        self.sq = _shards(shards.sq_norms, mesh, axis)

    def _local(self, s, ids, mask):
        dev = self.devices[s]
        loc = ids.to(dev).long() - s * self.n_local
        own = mask.to(dev) & (loc >= 0) & (loc < self.n_local)
        return own, torch.clamp(loc, 0, self.n_local - 1)

    def gather(self, ids, take):
        parts = []
        for s in range(len(self.devices)):
            own, safe = self._local(s, ids, take)
            r = self.nbr0[s][safe]                          # [B, E, M]
            parts.append(torch.where(own[:, :, None], r + 1, 0))
        return _psum(parts, self.device) - 1                # -1 when dead

    def score(self, q, q_sq, cand, ok, metric):
        parts = []
        for s, dev in enumerate(self.devices):
            own, safe = self._local(s, cand, ok)
            cv = self.vecs[s][safe].to(torch.float32)
            d = gathered_dist(q.to(dev), cv, self.sq[s][safe], q_sq.to(dev),
                              metric=metric, precision=HIGHEST)
            parts.append(torch.where(own, d, 0.0))
        return torch.where(ok, _psum(parts, self.device), _INF)


def _search(rows, pids, pvecs, psq, q, *, k: int, ef: int, seeds: int,
            metric: str, max_hops: int, expand: int,
            stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The replicated beam over a row exchange ``rows`` (_StackedRows or
    _ShardLoopRows)."""
    dev = rows.device
    B = q.shape[0]
    q = q.to(dev, torch.float32)
    q_sq = torch.sum(q * q, dim=-1)
    Pp = max(ef, k)
    E = max(1, min(expand, Pp))
    M = rows.nbr0[0].shape[-1]
    pids, pvecs, psq = pids.to(dev), pvecs.to(dev), psq.to(dev)
    s_seeds = int(min(seeds, pids.shape[0], Pp))

    # entry: the replicated pivot product (exact)
    pd = pairwise_dist(q, pvecs, v_sq=psq, metric=metric, precision=HIGHEST)
    seed_d, j = topk_smallest(pd, s_seeds)                  # ascending
    pool_i = torch.full((B, Pp), -1, dtype=torch.int32, device=dev)
    pool_i[:, :s_seeds] = pids[j].to(torch.int32)
    pool_d = torch.full((B, Pp), _INF, dtype=torch.float32, device=dev)
    pool_d[:, :s_seeds] = seed_d
    expanded = torch.zeros((B, Pp), dtype=torch.bool, device=dev)

    def select(pool_d, pool_i, expanded):
        sel_d = torch.where(expanded | (pool_i < 0), _INF, pool_d)
        best, jj = topk_smallest(sel_d, E)
        worst = pool_d.max(dim=1).values
        return jj, best < worst[:, None]

    jj, take = select(pool_d, pool_i, expanded)
    hop = 0
    while hop < max_hops and bool(take.any()):
        cur = torch.gather(pool_i, 1, jj)                   # [B, E]
        expanded = expanded.scatter(1, jj, torch.gather(expanded, 1, jj)
                                    | take)
        nbrs = rows.gather(torch.where(take, cur, 0), take).reshape(B, E * M)
        nb_ok = (nbrs >= 0) & take.repeat_interleave(M, dim=1)
        in_pool = (nbrs[:, :, None] == pool_i[:, None, :]).any(-1)
        nb_ok = nb_ok & ~in_pool
        cand = torch.where(nb_ok, nbrs, -1)
        d = rows.score(q, q_sq, torch.where(nb_ok, nbrs, 0), nb_ok, metric)
        # same-hop diamond twins: O(C^2) id-equality dedup before the
        # bitonic merge (core/search.py's hole-free-pool invariant)
        C = cand.shape[1]
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev),
                         diagonal=-1)
        dup = ((cand[:, :, None] == cand[:, None, :])
               & (cand[:, :, None] >= 0) & tri[None]).any(-1)
        d = torch.where(dup, _INF, d)
        cand = torch.where(dup, -1, cand)
        ei = torch.where(expanded & (pool_i >= 0), pool_i | _EXP_BIT,
                         pool_i)
        pool_d, packed = _bitonic_merge(pool_d, ei, d, cand.to(torch.int32),
                                        Pp)
        expanded = packed >= _EXP_BIT
        pool_i = torch.where(packed >= 0, packed & (_EXP_BIT - 1), packed)
        jj, take = select(pool_d, pool_i, expanded)
        hop += 1
    if stats is not None:
        stats.setdefault("hops", []).append(hop)
    fd, pos = torch.sort(pool_d, dim=1, stable=True)
    fi = torch.gather(pool_i, 1, pos)
    fi = torch.where(fd >= _INF, -1, fi)
    return fd[:, :k], fi[:, :k]


def rowsharded_graph_search(shards: RowShards, queries, *, k: int, ef: int,
                            seeds: int = 16, metric: str = "cosine",
                            max_hops: int = 128, expand: int = 2,
                            mesh: Mesh, axis: str = "data",
                            stats: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search ONE row-sharded graph for a replicated query batch.

    Returns (dists [B, k], global slot ids [B, k] int32) on the mesh's
    first device; -1 = miss. The row axis of nbr0 / vectors / sq_norms is
    split over ``axis``; queries and the pivot table are replicated.
    Shards on one device take the stacked exchange, else the shard loop
    (module docstring). ``stats`` (a dict), when given, gets the hop
    count appended to ``stats["hops"]``, as core/search.search_graph does.
    """
    metric = canonical_metric(metric)
    S = mesh.shape[axis]
    if shards.nbr0.shape[0] % S:
        raise ValueError(f"cap {shards.nbr0.shape[0]} not divisible by "
                         f"mesh size {S}; use make_row_shards")
    rows = (_StackedRows if mesh.one_device else _ShardLoopRows)(
        shards, mesh, axis)
    return _search(rows, shards.pivot_ids, shards.pivot_vecs,
                   shards.pivot_sq, queries.to(rows.device), k=k,
                   ef=ef, seeds=seeds, metric=metric, max_hops=max_hops,
                   expand=expand, stats=stats)
