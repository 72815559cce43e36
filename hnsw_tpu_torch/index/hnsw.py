"""Keyed HNSW graph (port of hnsw_tpu/index/hnsw.py).

Public API mirrors the reference ``Graph[K]`` (graph.go:437,534,843,942,
1047): add / batch_add / build / search / batch_search / delete.

Split of responsibilities:
  host   — key<->slot mapping, sequential mutation semantics and bulk
           construction (core/host_build.HostGraph, native C++ builder)
  device — batched query traffic (core/search.search_graph) on padded
           tensors; small batches go to the native host engine

Ported so far: the default configuration (f32 store, descent entry,
dense adjacency). The device wave builder (``method="device"``) is
ROADMAP Queue 1 item 8; the capacity modes (``hbm_mode``), neighbor
blocks, pivot entry and split upper layers are Queue 1 items 5 and 7.
"""

from __future__ import annotations

import functools
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import GraphConfig, canonical_metric
from hnsw_tpu_torch.core import host_build
from hnsw_tpu_torch.core.search import search_graph
from hnsw_tpu_torch.core.state import DeviceGraph, bucket_pow2, from_host
from hnsw_tpu_torch.index.exact import default_device
from hnsw_tpu_torch.ops.distance import INF_DIST
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap
from hnsw_tpu_torch.utils.rwlock import RWLock


def _writes(fn):
    """Mutation: exclusive hold on the graph's RWLock (graph.go:328's
    ``g.mu.Lock()``). Re-entrant."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._rw.write():
            return fn(self, *a, **kw)
    return wrapper


def _reads(fn):
    """Query/read path: shared hold (graph.go:328's ``g.mu.RLock()``).
    The lazily built device graph is written under the read hold:
    assignment is GIL-atomic and rebuilding twice is idempotent."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._rw.read():
            return fn(self, *a, **kw)
    return wrapper


class Graph:
    """HNSW index over arbitrary hashable keys, served with PyTorch."""

    def __init__(self, m: int = 16, ml: float = 0.25, ef_search: int = 20,
                 metric: str = "cosine", seed: int = 0,
                 ef_construction: int = 100,
                 config: Optional[GraphConfig] = None,
                 store=None, device=None):
        self.cfg = config or GraphConfig(m=m, ml=ml, ef_search=ef_search,
                                         metric=metric, seed=seed,
                                         ef_construction=ef_construction)
        self.cfg.validate()
        if self.cfg.store_dtype != "float32":
            raise NotImplementedError(
                f"store_dtype={self.cfg.store_dtype!r}: reduced-precision "
                "graph stores are ROADMAP Queue 1 item 5")
        self.metric = canonical_metric(self.cfg.metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.slots = SlotMap()
        self.store = store if store is not None else HostVectorStore()
        self.host = host_build.HostGraph(self.cfg, self.store)
        self._dev: Optional[DeviceGraph] = None
        self._dirty = True
        #: bf16 traversal matmuls + f32 rerank of the pool head
        self.fast_math = False
        #: per-hop pool update: "bitonic" (sorted-pool merge network) or
        #: "sort" (full stable sort)
        self.merge_strategy = "bitonic"
        #: LATENCY tier: batches up to this size are served by the native
        #: C++ engine on the host graph arrays, with no device round trip.
        #: 0 disables the native tier.
        self.native_serve_max_batch = 32
        #: hop counts of the last device search, one per layer, top first
        self.last_search_hops: List[int] = []
        self._ef_default: Optional[int] = None
        self._rw = RWLock()

    @property
    def ef_search(self) -> int:
        """Default search ef (``cfg.ef_search`` unless overridden)."""
        return self._ef_default if self._ef_default is not None \
            else self.cfg.ef_search

    @ef_search.setter
    def ef_search(self, ef: int) -> None:
        self._ef_default = int(ef)

    # Serving modes of the JAX Graph that are not ported yet: each takes
    # only its default value here.
    @property
    def hbm_mode(self) -> str:
        return "full"

    @hbm_mode.setter
    def hbm_mode(self, mode: str) -> None:
        if mode != "full":
            raise NotImplementedError(
                f"hbm_mode={mode!r}: the graph capacity modes are ROADMAP "
                "Queue 1 item 7")

    @property
    def entry_mode(self) -> str:
        return "descent"

    @entry_mode.setter
    def entry_mode(self, mode: str) -> None:
        if mode != "descent":
            raise NotImplementedError(
                f"entry_mode={mode!r}: pivot-seeded entry is ROADMAP "
                "Queue 1 item 7")

    @property
    def block_layout(self) -> bool:
        return False

    @block_layout.setter
    def block_layout(self, on: bool) -> None:
        if on:
            raise NotImplementedError(
                "neighbor-vector blocks are ROADMAP Queue 1 item 5")

    def __len__(self) -> int:
        return len(self.slots)

    # -- mutation ---------------------------------------------------------
    @_writes
    def add(self, key: Hashable, vector) -> None:
        """Insert one node; replaces an existing node with the same key
        (graph.go:437)."""
        vec = np.asarray(vector, np.float32)
        if key in self.slots:
            self.delete(key)
        slot, _ = self.slots.assign(key)
        self.store.put(slot, vec)
        self.host.insert_many([slot])
        self._dirty = True

    @_writes
    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        """Bulk insert (graph.go:942 BatchAdd semantics — sequential,
        duplicate keys replaced)."""
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        if len(set(keys)) != len(keys):
            # duplicate-in-batch: sequential last-wins (graph.go:1016-1023)
            for k, v in zip(keys, vectors):
                self.add(k, v)
            return
        for k in keys:
            if k in self.slots:
                self.delete(k)
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self.host.insert_many(slot_list)
        self._dirty = True

    @_writes
    def build(self, keys: Sequence[Hashable], vectors,
              method: str = "auto") -> None:
        """Bulk construction. Existing keys are replaced; duplicate keys
        within the batch are an error.

        method: "host" (native C++ sequential builder), "auto" (host up
        to 1M vectors), or "device" (the wave builder, ROADMAP Queue 1
        item 8 — not ported yet).
        """
        if method not in ("auto", "host", "device"):
            raise ValueError(
                f"unknown build method {method!r}: auto|host|device")
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        key_set = set(keys)
        if len(key_set) != len(keys):
            raise ValueError("duplicate keys in build batch")
        if method == "auto":
            from hnsw_tpu_torch import native
            method = ("host" if native.available()
                      and len(keys) <= 1_000_000 else "device")
        if method == "device":
            raise NotImplementedError(
                "device graph construction is ROADMAP Queue 1 item 8; "
                "use method='host'")
        for k in (self.slots.key_to_slot.keys() & key_set):
            self.delete(k)
        slot_list = self.slots.assign_fresh_batch(list(keys))
        self.store.put_batch(slot_list, vectors)
        self.host.insert_many(list(slot_list))
        self._dirty = True

    @_writes
    def delete(self, key: Hashable) -> bool:
        """Remove a node and repair its neighborhood
        (graph.go:843 Delete + isolate/replenish)."""
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        self.host.delete_many([slot])
        self.store.kill(slot)
        self.slots.release(key)
        self._dirty = True
        return True

    # -- device sync ------------------------------------------------------
    @_reads
    def device_graph(self) -> DeviceGraph:
        if self._dirty or self._dev is None:
            n = self.slots.capacity_used
            cap = bucket_pow2(max(n, 1), 8)
            nb, levels, entry, _ = self.host.arrays()
            use = min(nb.shape[1], cap)
            vecs = (self.store.vectors[:use]
                    if self.store.vectors is not None
                    else np.zeros((0, 1), np.float32))
            sqs = (self.store.sq_norms[:use]
                   if self.store.sq_norms is not None
                   else np.zeros((0,), np.float32))
            if self.metric == "cosine" and vecs.size:
                # pre-normalized store: cosine distances are invariant,
                # and hops skip the per-candidate norm gather entirely
                vecs = vecs / np.sqrt(np.maximum(sqs, 1e-30))[:, None]
                sqs = np.ones_like(sqs)
            # always the dense [L, cap, M0] adjacency: the JAX package
            # switches to compact upper layers above 1 GB to fit a 16 GB
            # chip; the results are the same, and the compact layout is
            # ROADMAP Queue 1 item 5
            self._dev = from_host(
                vecs, sqs, nb[:, :use], levels[:use],
                (self.store.alive[:use] if self.store.alive is not None
                 else np.zeros((0,), bool)),
                entry, cap_pad=cap, device=self.device)
            self._dirty = False
        return self._dev

    # -- search -----------------------------------------------------------
    @_reads
    def batch_search_slots(self, queries: np.ndarray, k: int,
                           ef: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self.slots) == 0:
            q = queries.shape[0]
            return (np.full((q, k), INF_DIST, np.float32),
                    np.full((q, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        ef = ef if ef is not None else self.ef_search
        if 0 < queries.shape[0] <= self.native_serve_max_batch:
            res = self._native_search(queries, k, ef)
            if res is not None:
                return res
        g = self.device_graph()
        nq = queries.shape[0]
        q_pad = bucket_pow2(nq)
        if q_pad != nq:
            queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
        pool = max(ef, k)
        expand = self.cfg.search_expand
        hops = max(self.cfg.max_hops, -(-2 * pool // expand))
        stats: dict = {}
        d, i = search_graph(g, torch.from_numpy(queries).to(self.device),
                            k=k, ef=ef, metric=self.metric, max_hops=hops,
                            expand=expand, fast_math=self.fast_math,
                            merge=self.merge_strategy, stats=stats)
        self.last_search_hops = stats["hops"]
        return (d[:nq].cpu().numpy(),
                i[:nq].cpu().numpy().astype(np.int64))

    def _native_search(self, queries: np.ndarray, k: int, ef: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Serve a small batch from the native C++ engine over the host
        graph arrays (same HNSW semantics as the device path). Returns
        None when the library or metric is unsupported — callers fall
        through to the device path."""
        from hnsw_tpu_torch import native
        res = native.search_batch(self.host, queries, k, ef)
        if res is None:
            return None
        d, i = res
        return d.astype(np.float32, copy=False), \
            i.astype(np.int64, copy=False)

    def _host_rerank(self, queries: np.ndarray, cand: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f32 rerank of per-query candidate slots against the host
        store (one batched fetch — the GetVectorsBatch role,
        parquet/vector_ops.go:321-432)."""
        from hnsw_tpu_torch.utils.rerank import host_rerank
        return host_rerank(self.store, self.metric, queries, cand, k)

    @_reads
    def batch_search(self, queries, k: int, ef: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """graph.go:1047 BatchSearch: (keys [Q][k], dists [Q,k])."""
        d, i = self.batch_search_slots(queries, k, ef)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    @_reads
    def search(self, query, k: int, ef: Optional[int] = None
               ) -> List[Tuple[Any, float]]:
        """graph.go:534 Search: [(key, dist)] best-first."""
        d, i = self.batch_search_slots(np.asarray(query, np.float32)[None],
                                       k, ef)
        return [(self.slots.key_of(int(s)), float(dd))
                for dd, s in zip(d[0], i[0]) if s >= 0]

    # -- misc -------------------------------------------------------------
    def keys(self) -> List[Any]:
        return list(self.slots.key_to_slot.keys())

    @property
    def num_layers(self) -> int:
        return self.host.top + 1
