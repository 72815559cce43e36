"""Sequential host-side graph construction — the parity oracle.

A faithful numpy re-implementation of the reference's mutation semantics
operating directly on the padded array representation (core/state.py):

  - level sampling:   graph.go:370-417 (maxLevel cap + geometric Ml)
  - insert descent:   graph.go:437-531 (elevator, per-layer beam, connect)
  - beam search:      graph.go:94-170  (result/candidate heaps, visited,
                      no-improvement termination)
  - addNeighbor:      graph.go:41-81   (worst-distance eviction + backlink
                      removal + replenish of the evictee)
  - replenish:        graph.go:172-219 (neighbors-of-neighbors refill;
                      uses the GRAPH's metric — the reference hardcodes
                      cosine there, a quirk we deliberately fix,
                      SURVEY.md §7.4)
  - delete/isolate:   graph.go:843-895, 223-235

Used for: small/incremental updates, the oracle that the batched device
construction (core/build.py) is validated against, and delete repair.
Bulk loads should go through the device builder.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from hnsw_tpu_torch.config import GraphConfig, canonical_metric
from hnsw_tpu_torch.utils.keystore import HostVectorStore


def max_level(ml: float, num_nodes: int) -> int:
    """Upper bound on layer count (graph.go:370-385)."""
    if num_nodes == 0:
        return 1
    return int(round(math.log(num_nodes) / math.log(1.0 / ml))) + 1


class HostGraph:
    """Padded-array HNSW with sequential reference-semantics mutation."""

    def __init__(self, cfg: GraphConfig, store: HostVectorStore):
        cfg.validate()
        self.cfg = cfg
        self.metric = canonical_metric(cfg.metric)
        self.store = store
        self.rng = np.random.default_rng(cfg.seed)
        # neighbors[l, slot] = int32 row, -1 pad. Row width = m_base
        # (layer-0 degree); upper layers use only the first m entries
        # (cfg.max_degree).
        self.neighbors = np.full((1, 0, cfg.m_base), -1, np.int32)
        self.levels = np.full((0,), -1, np.int32)
        self.entry: int = -1   # slot of a node on the top layer
        self.top: int = -1     # current top layer index (-1 = empty)
        self.count: int = 0

    # -- capacity ----------------------------------------------------------
    def _ensure(self, slot: int, level: int) -> None:
        cap = self.neighbors.shape[1]
        need_cap = max(cap, slot + 1)
        need_l = max(self.neighbors.shape[0], level + 1)
        if need_cap > cap or need_l > self.neighbors.shape[0]:
            grown_cap = cap
            if need_cap > cap:
                grown_cap = max(64, cap)
                while grown_cap < need_cap:
                    grown_cap *= 2
            nb = np.full((need_l, grown_cap, self.cfg.m_base), -1,
                         np.int32)
            nb[: self.neighbors.shape[0], :cap] = self.neighbors
            self.neighbors = nb
            if grown_cap > len(self.levels):
                lv = np.full((grown_cap,), -1, np.int32)
                lv[: len(self.levels)] = self.levels
                self.levels = lv

    # -- distances ---------------------------------------------------------
    def _dist_one(self, vec: np.ndarray, slot: int) -> float:
        return float(self._dist_many(vec, np.array([slot]))[0])

    def _dist_many(self, vec: np.ndarray, slots: np.ndarray) -> np.ndarray:
        v = self.store.vectors[slots]
        sq = self.store.sq_norms[slots]
        q_sq = float(np.dot(vec, vec))
        qv = v @ vec
        if self.metric == "cosine":
            return 1.0 - qv / np.sqrt(q_sq * sq + 1e-30)
        if self.metric == "sqeuclidean":
            return np.maximum(q_sq + sq - 2.0 * qv, 0.0)
        if self.metric == "l2":
            return np.sqrt(np.maximum(q_sq + sq - 2.0 * qv, 0.0))
        if self.metric == "dot":
            return -qv
        from hnsw_tpu_torch.ops.distance import np_pairwise_dist, registered
        if registered(self.metric) is not None:
            return np_pairwise_dist(vec[None], v, self.metric)[0]
        raise ValueError(self.metric)

    # -- level sampling (graph.go:388-417) ----------------------------------
    def random_level(self) -> int:
        cap = max_level(self.cfg.ml, self.count)
        for level in range(cap):
            if self.rng.random() > self.cfg.ml:
                return level
        return cap

    # -- beam search (graph.go:94-170) ---------------------------------------
    def search_layer(self, layer: int, vec: np.ndarray, start: int,
                     k: int, ef: int) -> List[Tuple[float, int]]:
        """Returns up to k (dist, slot) pairs sorted ascending.

        Classic HNSW searchLayer with a pool of ef: expand candidates
        best-first while the best candidate beats the worst pool entry.
        DELIBERATE improvement over the reference's variant
        (graph.go:107-166), whose "no improvement of the current best"
        termination stops after ~1 non-improving hop and whose result
        pool is only k wide — that combination caps recall regardless of
        ef (we measured recall saturating with ef there). The device
        search (core/search.py) implements the same classic rule, so
        host and device agree."""
        import bisect
        pool = max(ef, k)
        d0 = self._dist_one(vec, start)
        candidates: List[Tuple[float, int]] = [(d0, start)]  # ascending
        result: List[Tuple[float, int]] = [(d0, start)]      # ascending
        visited = {start}
        neigh = self.neighbors[layer]
        while candidates:
            d_cur, cur = candidates.pop(0)  # best-first
            if d_cur > result[-1][0] and len(result) >= pool:
                break
            row = neigh[cur]
            nbrs = row[row >= 0]
            fresh = [int(s) for s in nbrs if int(s) not in visited]
            if fresh:
                visited.update(fresh)
                ds = self._dist_many(vec, np.asarray(fresh))
                for d, s in zip(ds, fresh):
                    d = float(d)
                    if len(result) < pool or d < result[-1][0]:
                        bisect.insort(result, (d, s))
                        if len(result) > pool:
                            result.pop()
                        bisect.insort(candidates, (d, s))
        return result[:k]

    # -- edges (graph.go:41-81, 172-219) --------------------------------------
    def _row_remove(self, layer: int, slot: int, target: int) -> None:
        row = self.neighbors[layer, slot]
        hit = np.nonzero(row == target)[0]
        if len(hit):
            row[hit] = -1

    def add_neighbor(self, layer: int, n: int, new: int,
                     _depth: int = 0) -> None:
        """Insert ``new`` into n's neighbor row; evict the worst when full
        (graph.go:41-81). One-directional, as in the reference — callers
        add both directions explicitly."""
        if n == new:
            return
        deg_cap = self.cfg.max_degree(layer)
        row = self.neighbors[layer, n]
        if (row == new).any():
            return  # map semantics: already a neighbor
        filled = np.nonzero(row >= 0)[0]
        if len(filled) < deg_cap:
            free = np.nonzero(row < 0)[0]
            row[free[0]] = new
            return
        # Full: among current degree-cap + the newcomer, evict the
        # farthest from n.
        cands = np.concatenate([row[filled], [new]])
        d = self._dist_many(self.store.vectors[n], cands)
        worst_pos = int(np.argmax(d))
        worst = int(cands[worst_pos])
        if worst != new:
            row[filled[worst_pos]] = new
        # Remove backlink and replenish the evictee (graph.go:73-80).
        self._row_remove(layer, worst, n)
        if _depth < 32:  # recursion guard; reference recurses unboundedly
            self.replenish(layer, worst, _depth + 1)

    def replenish(self, layer: int, n: int, _depth: int = 0) -> None:
        """Refill n's neighbor row from neighbors-of-neighbors
        (graph.go:172-219), best-distance-first, up to the layer's
        degree cap."""
        deg_cap = self.cfg.max_degree(layer)
        row = self.neighbors[layer, n]
        have = row[row >= 0]
        if len(have) >= deg_cap:
            return
        exclude = set(int(s) for s in have)
        exclude.add(n)
        cands = []
        for nb in have:
            r2 = self.neighbors[layer, int(nb)]
            for c in r2[r2 >= 0]:
                c = int(c)
                if c not in exclude:
                    exclude.add(c)
                    cands.append(c)
        if not cands:
            return
        d = self._dist_many(self.store.vectors[n], np.asarray(cands))
        order = np.argsort(d, kind="stable")
        for pos in order:
            row = self.neighbors[layer, n]
            if (row >= 0).sum() >= deg_cap:
                break
            self.add_neighbor(layer, n, int(cands[pos]), _depth)

    # -- insert (graph.go:437-531) ---------------------------------------------
    def insert(self, slot: int, vec: np.ndarray,
               level: Optional[int] = None) -> None:
        if level is None:
            level = self.random_level()
        self._ensure(slot, level)
        if self.entry < 0:
            self.levels[slot] = level
            self.count += 1
            self.entry, self.top = slot, level
            return

        elevator = self.entry
        for layer in range(self.top, -1, -1):
            found = self.search_layer(layer, vec, elevator,
                                      k=self.cfg.max_degree(layer),
                                      ef=self.cfg.ef_construction)
            elevator = found[0][1]
            if level >= layer:
                for _, nb in found:
                    self.add_neighbor(layer, nb, slot)
                    self.add_neighbor(layer, slot, nb)
        self.levels[slot] = level
        self.count += 1
        if level > self.top:
            self.top, self.entry = level, slot

    # -- native-accelerated batch entry points -----------------------------
    def insert_many(self, slots, levels=None) -> None:
        """Sequential insert of stored slots; native C++ fast path with
        pure-Python fallback. Vectors must already be in the store."""
        slots = [int(s) for s in slots]
        if not slots:
            return
        if levels is None:
            # level cap grows with the running node count (graph.go:400)
            levels = []
            for i in range(len(slots)):
                cap = max_level(self.cfg.ml, self.count + i)
                lvl = 0
                while lvl < cap and self.rng.random() <= self.cfg.ml:
                    lvl += 1
                levels.append(lvl)
        self._ensure(max(slots), max(levels))
        from hnsw_tpu_torch import native
        done = 0
        if native.available():
            import numpy as _np

            from hnsw_tpu_torch.utils.progress import BuildHeartbeat

            # chunked native calls so a multi-minute sequential build
            # heartbeats like the device waves do (per-call ctypes
            # overhead is pointer marshalling only); a False return
            # leaves the arrays for that chunk untouched, so the Python
            # fallback resumes from `done`
            hb = BuildHeartbeat(len(slots), "host build")
            step = 16384
            for c0 in range(0, len(slots), step):
                if not native.insert_batch(
                        self,
                        _np.asarray(slots[c0:c0 + step], _np.int64),
                        _np.asarray(levels[c0:c0 + step], _np.int32)):
                    break
                done = min(c0 + step, len(slots))
                if done < len(slots) and hb.due():
                    hb.emit(done)
            if done >= len(slots) and self.top >= 0 and self.entry >= 0:
                return
        for s, l in zip(slots[done:], levels[done:]):
            self.insert(s, self.store.vectors[s], level=l)

    def delete_many(self, slots) -> None:
        slots = [int(s) for s in slots if self.levels[int(s)] >= 0]
        if not slots:
            return
        from hnsw_tpu_torch import native
        if native.available():
            import numpy as _np
            if native.delete_batch(self,
                                   _np.asarray(slots, _np.int64)):
                return
        for s in slots:
            self.delete(s)

    # -- delete (graph.go:843-895, 223-235) --------------------------------------
    def delete(self, slot: int) -> None:
        level = int(self.levels[slot])
        if level < 0:
            return
        for layer in range(0, level + 1):
            # Vectorized in-edge sweep: the reference's isolate
            # (graph.go:223-235) only removes backlinks from the deleted
            # node's OWN neighbor list, leaving asymmetric in-edges (from
            # replenish) dangling as stale pointers. The array layout
            # makes the full sweep one masked compare — do it right.
            in_mask = self.neighbors[layer] == slot
            affected = np.nonzero(in_mask.any(axis=1))[0]
            self.neighbors[layer][in_mask] = -1
            self.neighbors[layer, slot] = -1
            for nb in affected:
                self.replenish(layer, int(nb))
        self.levels[slot] = -1
        self.count -= 1
        if slot == self.entry:
            self._refresh_entry()

    def _refresh_entry(self) -> None:
        """Re-pick entry/top after the entry node is deleted."""
        if self.count == 0:
            self.entry, self.top = -1, -1
            return
        alive = self.levels >= 0
        self.top = int(self.levels[alive].max())
        cands = np.nonzero(alive & (self.levels == self.top))[0]
        self.entry = int(cands[0])

    # -- export --------------------------------------------------------------
    def arrays(self):
        """(neighbors [L,cap,M], levels [cap], entry, top) — trimmed to the
        active layer count for device upload."""
        L = max(self.top + 1, 1)
        return (self.neighbors[:L], self.levels, self.entry, self.top)
