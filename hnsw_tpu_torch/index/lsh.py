"""LSH index (port of hnsw_tpu/index/lsh.py) — capability parity with
hybrid/lsh.go.

Random-hyperplane LSH: T tables x B bits (defaults 4x8, seed 42 —
hybrid/hybrid.go:85-122, lsh.go:64). Hashing is one device matmul for
the whole batch (ops/hashing); buckets live on host as dicts; search =
bucket-union candidate generation (lsh.go:175 GetCandidates) + batched
exact re-rank on device (lsh.go:204 Search).
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.ops.distance import (HIGHEST, INF_DIST, gathered_dist,
                                         np_gram_epilogue)
from hnsw_tpu_torch.ops.hashing import (hash_codes, make_hyperplanes,
                                        np_hash_codes)
from hnsw_tpu_torch.core.state import bucket_pow2, default_device, upload
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap


class LSHIndex:
    """Approximate index via locality-sensitive hashing."""

    def __init__(self, dim: Optional[int] = None, metric: str = "cosine",
                 num_tables: int = 4, num_bits: int = 8, seed: int = 42,
                 device=None):
        if num_bits > 30:
            raise ValueError("num_bits must be <= 30 (int32 packing)")
        self.metric = canonical_metric(metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.num_tables = num_tables
        self.num_bits = num_bits
        self.seed = seed
        self.slots = SlotMap()
        self.store = HostVectorStore(dim)
        self.planes: Optional[np.ndarray] = None  # lazy init (lsh.go:64)
        # tables[t]: code -> set of slots (lsh.go's []map[uint64][]K)
        self.tables: List[Dict[int, Set[int]]] = [
            dict() for _ in range(num_tables)]
        self._codes: Dict[int, np.ndarray] = {}  # slot -> [T] codes
        self._dev = None
        self._dirty = True
        #: LATENCY tier: batches up to this size hash + re-rank on host
        #: (numpy) — no device round trip per call. The
        #: candidate sets are bucket unions (tiny); a host gather+dot
        #: over them is microseconds. 0 disables.
        self.host_serve_max_batch = 16

    def _ensure_planes(self, dim: int) -> None:
        if self.planes is None:
            self.planes = make_hyperplanes(self.num_tables, self.num_bits,
                                           dim, self.seed)

    # -- mutation -----------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        self.store.ensure_dim(vectors.shape[1])
        self._ensure_planes(vectors.shape[1])
        for k in keys:
            if k in self.slots:
                self.delete(k)
        slot_list = np.asarray([self.slots.assign(k)[0] for k in keys])
        self.store.put_batch(slot_list, vectors)
        # hash in bounded chunks: no single upload passes 256 MB, and
        # hashing is chunk-local, so nothing is lost
        planes_dev = torch.from_numpy(self.planes).to(self.device)
        # row size from shape, not vectors[0]: an empty (0, d) batch
        # must not IndexError before the len()-guarded codes path
        step = max(1, (256 << 20)
                   // max(int(vectors.shape[1]) * vectors.itemsize, 1))
        codes = np.concatenate([
            hash_codes(torch.from_numpy(np.ascontiguousarray(
                vectors[c0:c0 + step])).to(self.device),
                planes_dev).cpu().numpy()
            for c0 in range(0, len(vectors), step)]) \
            if len(vectors) else np.zeros((0, self.num_tables), np.int64)
        for slot, code_row in zip(slot_list, codes):
            slot = int(slot)
            self._codes[slot] = code_row
            for t in range(self.num_tables):
                self.tables[t].setdefault(int(code_row[t]), set()).add(slot)
        self._dirty = True

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        code_row = self._codes.pop(slot, None)
        if code_row is not None:
            for t in range(self.num_tables):
                bucket = self.tables[t].get(int(code_row[t]))
                if bucket:
                    bucket.discard(slot)
                    if not bucket:
                        del self.tables[t][int(code_row[t])]
        self.store.kill(slot)
        self.slots.release(key)
        self._dirty = True
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    def __len__(self) -> int:
        return len(self.slots)

    def close(self) -> None:
        self._dev = None

    # -- candidates + search ---------------------------------------------------
    def get_candidates(self, query) -> List[int]:
        """Union of the query's buckets across tables (lsh.go:175)."""
        query = np.asarray(query, np.float32)
        if self.planes is None or len(self.slots) == 0:
            return []
        codes = hash_codes(
            torch.from_numpy(np.ascontiguousarray(query[None]))
            .to(self.device),
            torch.from_numpy(self.planes).to(self.device))[0].cpu().numpy()
        out: Set[int] = set()
        for t in range(self.num_tables):
            out |= self.tables[t].get(int(codes[t]), set())
        return sorted(out)

    def _dev_arrays(self):
        if self._dirty or self._dev is None:
            n = self.slots.capacity_used
            n_pad = bucket_pow2(max(n, 8))
            dim = self.store.dim
            # LSH is a very-large-tier index, so this is a GB-scale
            # table: it goes up in bounded chunks into a tensor padded on
            # the device, with no full-size padded host copy
            self._dev = None                 # free the old table first
            v = upload(self.store.vectors[:n], 0.0, (n_pad, dim),
                       self.device)
            sq = upload(self.store.sq_norms[:n], 0.0, (n_pad,),
                        self.device)
            self._dev = (v, sq)
            self._dirty = False
        return self._dev

    def batch_search(self, queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        """Bucket-union candidates per query, then batched exact re-rank
        on the device. Queries are GROUPED by pow2-bucketed candidate count
        so one hot bucket doesn't inflate the whole batch's padded
        re-rank matmul (each group pays for its own width)."""
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        out_d = np.full((Q, k), INF_DIST, np.float32)
        out_i = np.full((Q, k), -1, np.int64)
        if len(self.slots) == 0:
            return [[None] * k for _ in range(Q)], out_d
        if 0 < Q <= self.host_serve_max_batch:
            return self._host_batch_search(queries, k, out_d, out_i)
        cand_lists = [self.get_candidates(q) for q in queries]
        groups: Dict[int, List[int]] = {}
        for qi, cl in enumerate(cand_lists):
            if cl:
                groups.setdefault(bucket_pow2(len(cl), 8), []).append(qi)

        v, sq = self._dev_arrays()
        for C, idxs in groups.items():
            nq = len(idxs)
            Qp = bucket_pow2(nq, 8)
            qv = np.zeros((Qp, queries.shape[1]), np.float32)
            qv[:nq] = queries[idxs]
            cp = np.full((Qp, C), -1, np.int64)
            for j, qi in enumerate(idxs):
                cp[j, :len(cand_lists[qi])] = cand_lists[qi]
            d = _lsh_rerank(torch.from_numpy(qv).to(self.device), v, sq,
                            torch.from_numpy(cp).to(self.device),
                            self.metric)[:nq].cpu().numpy()
            kk = min(k, C)
            order = np.argsort(d, axis=1, kind="stable")[:, :kk]
            dd = np.take_along_axis(d, order, axis=1)
            ii = np.take_along_axis(cp[:nq], order, axis=1)
            ii = np.where(dd < INF_DIST / 2, ii, -1)
            for j, qi in enumerate(idxs):
                out_d[qi, :kk] = dd[j]
                out_i[qi, :kk] = ii[j]
        keys = [self.slots.keys_for(row) for row in out_i]
        return keys, out_d

    def _host_batch_search(self, queries: np.ndarray, k: int,
                           out_d: np.ndarray, out_i: np.ndarray
                           ) -> Tuple[List[List[Any]], np.ndarray]:
        """Latency tier: hash + bucket-union + exact re-rank entirely on
        host. Candidate sets are small (bucket unions), so a numpy
        gather + dot per query costs less than a device round trip at
        B=1."""
        codes = np_hash_codes(queries, self.planes)       # [Q, T]
        for qi in range(queries.shape[0]):
            cand: Set[int] = set()
            for t in range(self.num_tables):
                cand |= self.tables[t].get(int(codes[qi, t]), set())
            if not cand:
                continue
            cl = np.fromiter(cand, np.int64, len(cand))
            cl.sort()
            q = queries[qi]
            rows = self.store.vectors[cl]
            qv = rows @ q
            c_sq = self.store.sq_norms[cl]
            d = np_gram_epilogue(qv, float(q @ q), c_sq, self.metric)
            kk = min(k, len(cl))
            order = np.argsort(d, kind="stable")[:kk]
            out_d[qi, :kk] = d[order]
            out_i[qi, :kk] = cl[order]
        keys = [self.slots.keys_for(row) for row in out_i]
        return keys, out_d

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        keys, dists = self.batch_search(np.asarray(query, np.float32)[None], k)
        return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                if kk is not None]


def _lsh_rerank(queries: torch.Tensor, vectors: torch.Tensor,
                sq: torch.Tensor, cands: torch.Tensor,
                metric: str) -> torch.Tensor:
    """Distances from each query to ITS candidate list ([-1 padded])."""
    safe = torch.clamp(cands, 0, vectors.shape[0] - 1)
    cv = vectors[safe]
    cs = sq[safe]
    q_sq = torch.sum(queries * queries, dim=-1)
    d = gathered_dist(queries, cv, cs, q_sq, metric=metric,
                      precision=HIGHEST)
    return torch.where(cands >= 0, d, float(INF_DIST))
