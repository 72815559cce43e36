"""Multi-host scale-out: independent index slices + host merge (port of
hnsw_tpu/parallel/multihost.py; framework-free, as there).

The reference sketches (but never implements) a distributed graph with
consistent hashing, a transport interface, and replicas
(hnsw-extensions/hnsw-extensions.md:233-271). Devices of one host act as
ONE index (parallel/sharded, parallel/partitioned); across hosts the
network is slow and coordination is host-side, so the unit there is an
INDEPENDENT index per slice with deterministic key routing and a
host-side top-k merge: only the query fan-out and k-sized results cross
the network.

``Transport`` abstracts how a slice is reached; ``LocalTransport`` runs
slices in-process (tests, single-host), and any RPC layer can implement
the same two methods to go cross-host (parallel/rpc.SocketTransport).
Replication: ``replicas > 1`` writes each key to that many slices
(round-robin ring walk) and reads prefer the first live replica.

Slices are called from a thread pool, one call per slice at a time.
Several slices may be indexes on one card: each call runs on the
calling thread's current CUDA stream, and every result crosses back as
numpy (the SearchableIndex protocol).
"""

from __future__ import annotations

import hashlib
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from hnsw_tpu_torch.ops.distance import INF_DIST


class Transport:
    """How to reach a slice. Implementations provide two calls; both are
    synchronous (callers batch; network latency amortizes over the
    batch)."""

    def num_slices(self) -> int:
        raise NotImplementedError

    def call(self, slice_id: int, method: str, *args, **kw):
        """Invoke ``method`` on the slice's index object."""
        raise NotImplementedError


class LocalTransport(Transport):
    """All slices in this process — the test/single-host transport."""

    def __init__(self, indexes: Sequence[Any]):
        self.indexes = list(indexes)

    def num_slices(self) -> int:
        return len(self.indexes)

    def call(self, slice_id: int, method: str, *args, **kw):
        return getattr(self.indexes[slice_id], method)(*args, **kw)


def _ring_hash(key: Hashable, n: int) -> int:
    """Deterministic, process-independent key -> slice hash."""
    h = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % n


class MultiHostIndex:
    """Sharded index over independent slices with host-side merge.

    Each slice object must speak the SearchableIndex protocol
    (batch_add / batch_delete / batch_search / __len__). Keys route by
    consistent hash; with ``replicas`` > 1 each key lands on that many
    consecutive ring positions (the reference sketch's replication).
    """

    def __init__(self, transport: Transport, replicas: int = 1):
        if replicas < 1 or replicas > transport.num_slices():
            raise ValueError("replicas must be in [1, num_slices]")
        self.transport = transport
        self.replicas = replicas
        # Slice calls fan out concurrently: over a network each slice's
        # latency is independent, so sequential fan-out would sum them.
        # The pool is per-index and sized to the slice count (bounded).
        self._pool = ThreadPoolExecutor(
            max_workers=transport.num_slices(),
            thread_name_prefix="mh-slice")

    def _fan_out(self, calls: Sequence[Tuple[int, str, tuple, dict]],
                 max_failures: int) -> List[Any]:
        """Run slice calls concurrently. Returns a result per call;
        a failed call yields None. The first failure re-raises once
        more than ``max_failures`` calls fail — 0 for writes (a dropped
        write is silent data loss), replicas-1 for reads (fewer dead
        slices than replicas cannot uncover any key)."""
        futs = [self._pool.submit(self.transport.call, s, m, *a, **kw)
                for s, m, a, kw in calls]
        results: List[Any] = []
        n_failed = 0
        first_err: Optional[BaseException] = None
        for (s, m, _, _), f in zip(calls, futs):
            try:
                results.append(f.result())
            except Exception as e:
                results.append(None)
                n_failed += 1
                if first_err is None:
                    first_err = e
                warnings.warn(f"slice {s} {m} failed: {e}",
                              RuntimeWarning, stacklevel=3)
        if n_failed > max_failures:
            raise first_err
        return results

    @property
    def n(self) -> int:
        return self.transport.num_slices()

    def _owners(self, key: Hashable) -> List[int]:
        first = _ring_hash(key, self.n)
        return [(first + r) % self.n for r in range(self.replicas)]

    # -- mutation ------------------------------------------------------------
    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        groups: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            for s in self._owners(k):
                groups.setdefault(s, []).append(i)
        self._fan_out(
            [(s, "batch_add", ([keys[i] for i in idxs], vectors[idxs]),
              {}) for s, idxs in groups.items()],
            max_failures=0)  # writes must not silently drop

    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        groups: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            for s in self._owners(k):
                groups.setdefault(s, []).append(i)
        ok = [False] * len(keys)
        items = list(groups.items())
        res_per = self._fan_out(
            [(s, "batch_delete", ([keys[i] for i in idxs],), {})
             for s, idxs in items],
            max_failures=0)
        for (s, idxs), res in zip(items, res_per):
            for i, r in zip(idxs, res):
                ok[i] = ok[i] or bool(r)
        return ok

    def delete(self, key: Hashable) -> bool:
        return self.batch_delete([key])[0]

    def __len__(self) -> int:
        total = sum(self.transport.call(s, "__len__")
                    for s in range(self.n))
        # replicated keys counted once
        return total // self.replicas

    # -- search ------------------------------------------------------------------
    def batch_search(self, queries, k: int, **kw
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """Fan the batch to every slice, merge top-k host-side.

        Only (queries down, k results up) cross the network —
        per-slice work stays inside its own mesh/process. Duplicate
        keys from replicas are deduped keeping the best distance.
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        # Concurrent fan-out. Up to replicas-1 dead slices are
        # tolerated (every key still has a surviving replica — the
        # read-failover promise); at replicas dead slices some key
        # pair of owners may ALL be down, so it raises rather than
        # silently dropping keys.
        per_slice = [r for r in self._fan_out(
            [(s, "batch_search", (queries, k), kw)
             for s in range(self.n)],
            max_failures=self.replicas - 1) if r is not None]
        out_keys: List[List[Any]] = []
        out_d = np.full((Q, k), INF_DIST, np.float32)
        for qi in range(Q):
            best: Dict[Any, float] = {}
            for keys_s, dists_s in per_slice:
                for kk, dd in zip(keys_s[qi], np.asarray(dists_s[qi])):
                    if kk is None:
                        continue
                    dd = float(dd)
                    if dd < best.get(kk, np.inf):
                        best[kk] = dd
            ranked = sorted(best.items(), key=lambda r: r[1])[:k]
            row_keys = [kk for kk, _ in ranked]
            for j, (_, dd) in enumerate(ranked):
                out_d[qi, j] = dd
            row_keys.extend([None] * (k - len(row_keys)))
            out_keys.append(row_keys)
        return out_keys, out_d

    def search(self, query, k: int, **kw) -> List[Tuple[Any, float]]:
        keys, dists = self.batch_search(
            np.asarray(query, np.float32)[None], k, **kw)
        return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                if kk is not None]

    def stats(self) -> Dict[str, Any]:
        return {"slices": self.n, "replicas": self.replicas,
                "per_slice": [self.transport.call(s, "__len__")
                              for s in range(self.n)]}

    def close(self) -> None:
        """Release the fan-out worker pool. The transport stays open —
        its creator owns its lifecycle (it may be shared across
        MultiHostIndex instances)."""
        self._pool.shutdown(wait=False)
