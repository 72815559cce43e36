"""Exact (brute-force) index (port of hnsw_tpu/index/exact.py).

Capability parity with the reference ``ExactIndex`` (hybrid/exact.go:13,
61-111): the whole table is scored in batched matmul sweeps with a running
top-k (ops/topk.exact_topk), or, on a CUDA device at 32768+ rows, by the
fused CUDA screen (ops/exact_screen.exact_topk_fused). This is also the
recall ground-truth oracle.

The device table is float32 by default. The capacity modes keep a
reduced-precision table instead (``hbm_dtype`` int8 with per-row scales,
bf16, fp16, or "auto", which walks that ladder down to float32): a scan
nominates k + margin candidates (ops/exact_screen.capacity_scan: on a
CUDA table the capacity screen, the fused CUDA kernel with the table's
store; else the plain ops/topk.quantized_topk_candidates) and one
batched host fetch restores exact f32 ordering (utils/rerank.host_rerank).
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_dtype, canonical_metric
from hnsw_tpu_torch.core.state import bucket_pow2, default_device, upload
from hnsw_tpu_torch.ops.distance import (INF_DIST, np_bf16_round,
                                         np_gram_epilogue)
from hnsw_tpu_torch.ops.exact_screen import capacity_scan, exact_scan
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap


#: device table dtype of each capacity rung (int8 is built separately)
_HBM_TORCH = {"float32": torch.float32, "bf16": torch.bfloat16,
              "fp16": torch.float16}


def _pad_queries(queries: np.ndarray) -> np.ndarray:
    """Pad the batch to a power of two (at least 8) of zero rows."""
    nq = queries.shape[0]
    q_pad = bucket_pow2(nq)
    if q_pad != nq:
        queries = np.pad(queries, ((0, q_pad - nq), (0, 0)))
    return queries


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
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]] = None
        self._dirty = True
        #: CAPACITY mode: the device table is stored reduced-precision —
        #: "int8" (1 byte/dim, per-row scales; not for tightly clustered
        #: data), "bf16" (2 bytes/dim) or "fp16" (2 bytes/dim with 11
        #: significand bits, the tight-cluster rung). The scan nominates
        #: k + margin candidates and one host fetch restores exact f32
        #: ordering. "auto" walks int8 -> bf16 -> fp16 -> float32 with a
        #: full-density containment check (_reduced_fit).
        self.hbm_dtype = hbm_dtype
        self._hbm_fit_cache: Optional[Tuple[str, int]] = None
        self._muts_since_fit = 0          # vectors changed since check
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

    @property
    def hbm_dtype(self) -> str:
        """The capacity rung (see __init__). Setting it drops the device
        table; the next search builds the new one."""
        return self._hbm_dtype

    @hbm_dtype.setter
    def hbm_dtype(self, dtype: str) -> None:
        self._hbm_dtype = canonical_dtype(
            dtype, ("float32", "bf16", "fp16", "int8", "auto"), "hbm_dtype")
        self._resolved_hbm = self._hbm_dtype
        self._dev = None
        self._dirty = True

    # -- mutation ----------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        slot, _ = self.slots.assign(key)
        self.store.put(slot, np.asarray(vector, np.float32))
        self._muts_since_fit += 1
        self._dirty = True
        self._host_scan = None

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self._muts_since_fit += len(keys)
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
            qr = np_bf16_round(qr)
            prq = np_bf16_round(pr)
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

    def _resolve_hbm_dtype(self, n: int) -> str:
        """Resolve "auto" once per data regime (re-checked when the index
        doubles or halves, or a quarter of it changed): full-density
        ranking-fidelity checks int8 -> bf16 -> fp16 -> float32, the
        first rung scoring >= 0.99 wins (fp16 costs the same memory as
        bf16, so data that fails both 2-byte rungs pays f32 capacity)."""
        if self.hbm_dtype != "auto":
            return self.hbm_dtype
        c = self._hbm_fit_cache
        if (c is not None and c[1] <= 2 * n and n <= 2 * c[1]
                and self._muts_since_fit <= 0.25 * c[1]):
            return c[0]
        rows = self.store.vectors[:n]
        # 0.99 containment floor: the exact tier's contract is
        # near-perfect recall; borderline data costs f32 capacity rather
        # than recall
        for dt in ("int8", "bf16", "fp16"):
            if self._reduced_fit(rows, dt) >= 0.99:
                break
        else:
            dt = "float32"
        self._hbm_fit_cache = (dt, n)
        self._muts_since_fit = 0
        return dt

    def _sync(self):
        """Device table (v [n_pad, D], sq [n_pad] f32, alive [n_pad],
        scales [n_pad] f32 or None); n_pad is n bucketed to a power of
        two, the tail masked invalid. ``v`` is float32, or the resolved
        capacity rung: int8 with per-row scales, bf16 or fp16, each
        converted on the host per chunk (no full-size f32 copy is staged
        on the device). Rebuilt after any mutation."""
        if self._dirty or self._dev is None:
            self._dev = None                 # free the old table first
            n = self.slots.capacity_used
            self._resolved_hbm = self._resolve_hbm_dtype(n)
            n_pad = bucket_pow2(n)
            dim = self.store.dim
            dev = self.device
            rows = self.store.vectors[:n]
            sq = upload(self.store.sq_norms[:n], 0, (n_pad,), dev)
            alive = upload(self.store.alive[:n], False, (n_pad,), dev)
            scales = None
            if self._resolved_hbm == "int8":
                v = torch.zeros((n_pad, dim), dtype=torch.int8, device=dev)
                scales = torch.zeros((n_pad,), dtype=torch.float32,
                                     device=dev)
                step = max(1, (64 << 20) // (4 * dim))
                for c0 in range(0, n, step):  # bounded f32 quant temps
                    r = rows[c0:c0 + step]
                    amax = np.max(np.abs(r), axis=1)
                    s = np.where(amax > 0, amax / 127.0, 1.0)
                    v[c0:c0 + len(r)].copy_(torch.from_numpy(np.clip(
                        np.rint(r / s[:, None]), -127, 127).astype(np.int8)))
                    scales[c0:c0 + len(r)].copy_(
                        torch.from_numpy(s.astype(np.float32)))
            else:
                v = upload(rows, 0, (n_pad, dim), dev,
                           _HBM_TORCH[self._resolved_hbm])
            self._dev = (v, sq, alive, scales)
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
        v, sq, alive, _ = self._sync()
        nq = queries.shape[0]
        queries = _pad_queries(queries)
        if self._resolved_hbm != "float32":
            return self._finish_capacity_scan(
                queries, nq, k, *self._dispatch_capacity_scan(queries, k))
        q = torch.from_numpy(queries).to(self.device)
        # the fused CUDA screen at large N (the [Q, N] scores never reach
        # device memory); the chunked matmul scan at small N / large k /
        # on the CPU (exact_screen.fused_applies)
        d, i = exact_scan(q, v, sq, alive, k=k, metric=self.metric,
                          fast_math=self.fast_math)
        return (d[:nq].cpu().numpy(),
                i[:nq].cpu().numpy().astype(np.int64))

    def _dispatch_capacity_scan(self, queries_padded: np.ndarray, k: int):
        """Capacity-mode scan DISPATCH: the reduced-precision scan
        nominates k + margin candidates (int8 needs the wider margin: a
        per-row scale cannot rank close ties). On CUDA the scan is only
        queued; its candidates are queued for a copy into pinned host
        buffers right behind it, with an event recorded after that copy.
        Returns (dists, ids, event or None) for _finish_capacity_scan.

        The copy must be queued before the NEXT batch's scan: a plain
        ``.cpu()`` issued later would wait behind that scan on the same
        stream, and batch_search_stream would not overlap."""
        v, sq, alive, scales = self._sync()
        margin = max(16, k // 2) if self._resolved_hbm == "int8" \
            else max(4, k // 8)
        kk = min(k + margin, v.shape[0])
        # the padded tail holds no valid row: scan the used prefix only
        n = self.slots.capacity_used
        dev = self.device
        q = torch.from_numpy(queries_padded)
        if dev.type == "cuda":
            q = q.pin_memory().to(dev, non_blocking=True)
        d, i = capacity_scan(
            q, v[:n], None if scales is None else scales[:n], sq[:n],
            alive[:n], kk=kk, metric=self.metric)
        if dev.type != "cuda":
            return d, i, None
        hd = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        hi = torch.empty(i.shape, dtype=i.dtype, pin_memory=True)
        hd.copy_(d, non_blocking=True)
        hi.copy_(i, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return hd, hi, ready

    def _finish_capacity_scan(self, queries_padded, nq: int, k: int,
                              d_cand, i_cand, ready):
        """Capacity-mode scan FINISH: wait for the candidates and restore
        exact f32 ordering with one batched host fetch. INF-dist rows are
        masked fillers, dropped so the rerank cannot resurrect them."""
        from hnsw_tpu_torch.utils.rerank import host_rerank
        if ready is not None:
            ready.synchronize()
        cand = np.where(d_cand[:nq].numpy() >= INF_DIST, -1,
                        i_cand[:nq].numpy().astype(np.int64))
        return host_rerank(self.store, self.metric, queries_padded[:nq],
                           cand, k)

    def batch_search_stream(self, batches, k: int):
        """Pipelined serving for a STREAM of query batches: batch i+1's
        device scan is dispatched BEFORE batch i's host rerank runs, so
        in the capacity modes the rerank overlaps the next scan. Yields
        ``(dists [B, k], slots [B, k])`` per batch, in order, equal to
        batch_search_slots of each batch. Modes without a host rerank
        serve sequentially (there is nothing to overlap)."""
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        if len(self.slots) > 0:
            self._sync()
        if len(self.slots) == 0 or self._resolved_hbm == "float32":
            for q in batches:
                yield self.batch_search_slots(q, k)
            return
        pending = None      # (queries_padded, nq, k, dists, ids, event)
        for q in batches:
            q = np.atleast_2d(np.asarray(q, np.float32))
            self.store.ensure_dim(q.shape[-1])
            nq = q.shape[0]
            q = _pad_queries(q)
            scan = self._dispatch_capacity_scan(q, k)
            if pending is not None:
                yield self._finish_capacity_scan(*pending)
            pending = (q, nq, k) + tuple(scan)
        if pending is not None:
            yield self._finish_capacity_scan(*pending)

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

