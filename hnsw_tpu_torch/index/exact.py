"""Exact (brute-force) index (port of hnsw_tpu/index/exact.py).

Capability parity with the reference ``ExactIndex`` (hybrid/exact.go:13,
61-111): the whole table is scored in batched matmul sweeps with a running
top-k (ops/topk.exact_topk), or, on a CUDA device at 32768+ rows, by the
fused CUDA screen (ops/exact_screen.exact_topk_fused). This is also the
recall ground-truth oracle.

The device table is float32; the reduced-precision capacity modes
(``hbm_dtype`` bf16/fp16/int8/auto) are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_dtype, canonical_metric
from hnsw_tpu_torch.core.state import bucket_pow2
from hnsw_tpu_torch.ops.distance import INF_DIST, np_gram_epilogue
from hnsw_tpu_torch.ops.topk import exact_topk
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap


def default_device() -> torch.device:
    """The first CUDA device when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class ExactIndex:
    """Brute-force k-NN index with a host key map and a device vector store.

    API mirrors the reference VectorIndex/SearchableIndex interfaces
    (hybrid/hybrid.go:15-60): add / batch_add / search / batch_search /
    delete / batch_delete / __len__ / close.
    """

    def __init__(self, dim: Optional[int] = None, metric: str = "cosine",
                 fast_math: bool = False, hbm_dtype: str = "float32",
                 device=None):
        self.metric = canonical_metric(metric)
        self.slots = SlotMap()
        self.store = HostVectorStore(dim)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = None
        self._dirty = True
        hbm_dtype = canonical_dtype(
            hbm_dtype, ("float32", "bf16", "fp16", "int8", "auto"),
            "hbm_dtype")
        if hbm_dtype != "float32":
            raise NotImplementedError(
                f"hbm_dtype={hbm_dtype!r}: the reduced-precision capacity "
                "modes are ROADMAP Queue 1 item 4; only float32 is ported")
        self.hbm_dtype = hbm_dtype
        #: bf16 scan with f32 rerank of the winners (exact final ordering
        #: up to pool membership). f32 stays the ground-truth default.
        self.fast_math = fast_math
        #: LATENCY tier: batches up to this size (and at most
        #: host_serve_max_rows stored vectors) are scanned on host by the
        #: native engine, with no device round trip. Same exact results
        #: (f32 scan + stable ordering). 0 disables.
        self.host_serve_max_batch = 16
        self.host_serve_max_rows = 65536
        # native SIMD scan sidecar — see _host_scan_arrays. Invalidated on
        # every mutation.
        self._host_scan = None

    # -- mutation ----------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        slot, _ = self.slots.assign(key)
        self.store.put(slot, np.asarray(vector, np.float32))
        self._dirty = True
        self._host_scan = None

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self._dirty = True
        self._host_scan = None

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.release(key)
        if slot is None:
            return False
        self.store.kill(slot)
        self._dirty = True
        self._host_scan = None
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    def __len__(self) -> int:
        return len(self.slots)

    def close(self) -> None:
        self._dev = None

    # -- search ------------------------------------------------------------
    def _reduced_fit(self, rows: np.ndarray, quant: str,
                     probes: int = 32, k: int = 10) -> float:
        """CONTAINMENT of the true f32 top-k inside a reduced-precision
        scan's k+margin candidate pool, for off-node 0.85/0.15 member-mix
        probes against the FULL table (subsampling false-passes). Picks
        the native host scan's row precision (_host_scan_arrays). The
        bf16 and int8 rungs model both operands rounded to bf16 with f32
        accumulation; fp16 rounds the store only."""
        n = rows.shape[0]
        if n < 4 * k:
            return 1.0
        rng = np.random.default_rng(0)
        a = rng.choice(n, probes, replace=False)
        b = rng.choice(n, probes)
        b = np.where(b == a, (b + 1) % n, b)
        pr = (0.85 * rows[a] + 0.15 * rows[b]).astype(np.float32)
        if quant == "int8":
            amax = np.max(np.abs(rows), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0)
            qr = (np.clip(np.rint(rows / s[:, None]), -127, 127)
                  .astype(np.int8).astype(np.float32) * s[:, None])
            kk = k + max(16, k // 2)
        else:
            qr = rows.astype(np.float32)
            kk = k + max(4, k // 8)
        if quant == "fp16":
            qr = qr.astype(np.float16).astype(np.float32)
            prq = pr
        else:
            qr = _np_bf16(qr)
            prq = _np_bf16(pr)
        qv = prq @ qr.T
        sq = np.sum(rows.astype(np.float64) * rows, axis=1
                    ).astype(np.float32)
        p_sq = np.sum(pr * pr, axis=-1)
        dq = np_gram_epilogue(qv, p_sq[:, None], sq[None, :], self.metric)
        kk = min(kk, n)
        qt = np.argpartition(dq, kk - 1, axis=1)[:, :kk]
        from hnsw_tpu_torch.ops.topk import np_exact_topk
        _, gt = np_exact_topk(pr, rows, k, self.metric)
        hits = sum(len(set(gt[r]) & set(qt[r])) for r in range(probes))
        return hits / (probes * k)

    def _sync(self):
        """Device table (v [n_pad, D] f32, sq [n_pad], alive [n_pad]);
        n_pad is n bucketed to a power of two, the tail masked invalid.
        Plain host-to-device copies, rebuilt after any mutation."""
        if self._dirty or self._dev is None:
            n = self.slots.capacity_used
            n_pad = bucket_pow2(n)
            dim = self.store.dim
            dev = self.device
            v = torch.zeros((n_pad, dim), dtype=torch.float32, device=dev)
            sq = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
            alive = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
            if n:
                v[:n].copy_(torch.from_numpy(self.store.vectors[:n]))
                sq[:n].copy_(torch.from_numpy(self.store.sq_norms[:n]))
                alive[:n].copy_(torch.from_numpy(self.store.alive[:n]))
            self._dev = (v, sq, alive)
            self._dirty = False
        return self._dev

    def batch_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Core search: returns (dists [Q,k], slot ids [Q,k]; -1 = none)."""
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self.slots) == 0:
            q = queries.shape[0]
            return (np.full((q, k), INF_DIST, np.float32),
                    np.full((q, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        n_used = self.slots.capacity_used
        if (0 < queries.shape[0] <= self.host_serve_max_batch
                and n_used <= self.host_serve_max_rows):
            return self._host_search_slots(queries, k)
        v, sq, alive = self._sync()
        nq = queries.shape[0]
        q_pad = bucket_pow2(nq)
        if q_pad != nq:
            queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
        q = torch.from_numpy(queries).to(self.device)
        # the fused CUDA screen at large N (the [Q, N] scores never reach
        # device memory); the chunked matmul scan at small N / large k /
        # on the CPU
        use_fused = (v.shape[0] >= 32768 and k <= 120
                     and self.metric in ("cosine", "l2", "sqeuclidean",
                                         "dot")
                     and v.is_cuda)
        if use_fused:
            # exact_topk_fused reranks its winner pool in f32 internally,
            # so fused results are exact-ordered for both precisions.
            from hnsw_tpu_torch.ops.exact_screen import exact_topk_fused
            d, i = exact_topk_fused(q, v, sq, alive, k=k,
                                    metric=self.metric,
                                    fast_math=self.fast_math)
        else:
            d, i = exact_topk(q, v, sq, alive, k=k, metric=self.metric,
                              fast_math=self.fast_math)
        return (d[:nq].cpu().numpy(),
                i[:nq].cpu().numpy().astype(np.int64))

    def _host_scan_arrays(self):
        """Sidecar for the native SIMD scan (native.exact_scan): the
        reduced-precision ladder int8 -> fp16 -> f32; cosine rows are
        pre-normalized. The raw f32 store stays the rerank source, so
        final ordering is exact at every rung. Rebuilt lazily after any
        mutation."""
        n = self.slots.capacity_used
        c = self._host_scan
        if c is not None and c["n"] == n:
            return c
        rows = self.store.vectors[:n]
        if self.metric == "cosine":
            inv = 1.0 / np.sqrt(np.maximum(self.store.sq_norms[:n],
                                           1e-30))
            base = np.asarray(rows * inv[:, None], np.float32)
            sq = None
        else:
            base = rows
            sq = np.ascontiguousarray(self.store.sq_norms[:n],
                                      np.float32)
        scales = row_sums = None
        if n and self._reduced_fit(rows, "int8") >= 0.99:
            amax = np.max(np.abs(base), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            scan_rows = np.ascontiguousarray(
                np.clip(np.rint(base / s[:, None]), -127, 127), np.int8)
            scales = s
            row_sums = scan_rows.astype(np.int32).sum(axis=1)
            row_sums = np.ascontiguousarray(row_sums, np.int32)
        elif n and self._reduced_fit(rows, "fp16") >= 0.99:
            scan_rows = np.ascontiguousarray(base, np.float16)
        else:
            scan_rows = np.ascontiguousarray(base, np.float32)
        c = {"n": n, "rows": scan_rows, "sq": sq, "scales": scales,
             "row_sums": row_sums,
             "alive": np.ascontiguousarray(self.store.alive[:n],
                                           np.uint8),
             "rr_rows": np.ascontiguousarray(rows, np.float32),
             "rr_sq": np.ascontiguousarray(self.store.sq_norms[:n],
                                           np.float32)}
        self._host_scan = c
        return c

    def _host_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan on host — identical results to the device path at
        f32, without the per-call device round trip. Prefers the native
        fused SIMD scan (one C call); numpy/BLAS is the fallback."""
        from hnsw_tpu_torch import native
        n = self.slots.capacity_used
        if native.available():
            c = self._host_scan_arrays()
            # pre-marshalled call per (sidecar snapshot, k); the cache
            # dies with the sidecar on any mutation
            prep = c.setdefault("prepared", {}).get(k)
            if prep is None:
                margin = (max(16, k // 2) if c["rows"].dtype == np.int8
                          else max(8, k // 2))
                prep = native.PreparedScan(
                    c["rows"], k, min(max(n, k), k + margin),
                    self.metric, sq_norms=c["sq"], scales=c["scales"],
                    row_sums=c["row_sums"], alive=c["alive"],
                    rr_rows=c["rr_rows"], rr_sq=c["rr_sq"])
                c["prepared"][k] = prep
            if prep.ok:
                if not queries.flags["C_CONTIGUOUS"]:
                    queries = np.ascontiguousarray(queries)
                res = prep(queries)
                if res is not None:
                    d, i = res
                    i = np.where(d >= INF_DIST, -1, i)
                    return d, i
        v = self.store.vectors[:n]
        sq = self.store.sq_norms[:n]
        alive = self.store.alive[:n]
        qf = np.atleast_2d(np.asarray(queries, np.float32))
        qv = qf @ v.T                                        # [Q, n]
        q_sq = np.sum(qf * qf, axis=-1)
        d = np_gram_epilogue(qv, q_sq[:, None], sq[None, :], self.metric)
        d = np.where(alive[None, :], d, INF_DIST).astype(np.float32)
        kk = min(k, n)
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        dp = np.take_along_axis(d, part, axis=1)
        order = np.argsort(dp, axis=1, kind="stable")
        dd = np.take_along_axis(dp, order, axis=1)
        ii = np.take_along_axis(part, order, axis=1).astype(np.int64)
        ii = np.where(dd >= INF_DIST, -1, ii)
        if kk < k:
            pad = k - kk
            dd = np.pad(dd, ((0, 0), (0, pad)), constant_values=INF_DIST)
            ii = np.pad(ii, ((0, 0), (0, pad)), constant_values=-1)
        return dd, ii

    def batch_search(self, queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """Returns (keys [Q][<=k], dists [Q,k]) like SearchableIndex
        (hybrid/hybrid.go:39-60)."""
        d, i = self.batch_search_slots(np.asarray(queries, np.float32), k)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        """Single-query convenience: [(key, dist), ...] trimmed of misses."""
        d, i = self.batch_search_slots(np.asarray(query, np.float32)[None], k)
        out = []
        for dist, slot in zip(d[0], i[0]):
            if slot < 0:
                continue
            out.append((self.slots.key_of(int(slot)), float(dist)))
        return out

    # -- introspection -------------------------------------------------------
    def vector_of(self, key: Hashable) -> Optional[np.ndarray]:
        s = self.slots.slot_of(key)
        return None if s is None else np.array(self.store.get(s))

    def keys(self) -> List[Any]:
        return list(self.slots.key_to_slot.keys())


def _np_bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16 (nearest even), returned as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()
