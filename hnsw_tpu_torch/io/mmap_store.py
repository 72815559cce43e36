"""Disk-resident vector storage (copy of hnsw_tpu/io/mmap_store.py;
numpy only, same directory format) — the capability of the reference's
parquet VectorStore (parquet/vector_ops.go:18-63,321-432): vectors live
on DISK, RAM holds only a bounded working set, reads are batched.

The shape here: one flat little-endian f32 row file memory-mapped with
``np.memmap`` (the OS page cache IS the read cache — the reference
hand-rolls an LRU map because Go gives it no mmap ergonomics), plus a
small write-through RAM buffer for rows not yet flushed. The same
squared-norm/alive sidecars as HostVectorStore, kept in RAM (8 bytes +
1 bit per row — 1B rows ≈ 9 GB vectors' worth of sidecar per TB of
vectors; sidecars stay RAM-sized long past any single-host dataset).

API-compatible with utils/keystore.HostVectorStore so Graph / DiskGraph
/ ExactIndex can serve datasets where vector bytes >> RAM, with
``vectors`` exposed as the memmap (numpy fancy-indexing on a memmap does
batched page-granular reads — the GetVectorsBatch role).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_HEADER = "mmap_store.json"
_DATA = "vectors.f32"


class MmapVectorStore:
    """HostVectorStore-compatible store backed by a memory-mapped file.

    Capacity grows by doubling (file truncate + remap). Writes go to the
    memmap directly (write-back through the page cache); ``flush()``
    msyncs. Rows for free slots stay allocated, tombstoned via ``alive``
    (same array-graph contract as the RAM store).
    """

    def __init__(self, directory: str, dim: Optional[int] = None,
                 capacity: int = 1024, dtype=np.float32) -> None:
        if dtype != np.float32:
            raise ValueError("MmapVectorStore stores float32 rows")
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._dtype = np.float32
        self.dim: Optional[int] = None
        self.capacity = 0
        self.vectors: Optional[np.memmap] = None
        self.sq_norms: Optional[np.ndarray] = None
        self.alive: Optional[np.ndarray] = None
        header = os.path.join(directory, _HEADER)
        if os.path.exists(header):
            with open(header) as f:
                meta = json.load(f)
            self.dim = int(meta["dim"])
            self._map(int(meta["capacity"]))
            side = np.load(os.path.join(directory, "sidecar.npz"))
            n = min(self.capacity, len(side["sq_norms"]))
            self.sq_norms[:n] = side["sq_norms"][:n]
            self.alive[:n] = side["alive"][:n]
        elif dim is not None:
            self.dim = dim
            self._map(max(capacity, 1))

    # -- mapping ----------------------------------------------------------
    def _data_path(self) -> str:
        return os.path.join(self.dir, _DATA)

    def _map(self, capacity: int) -> None:
        path = self._data_path()
        nbytes = capacity * self.dim * 4
        with open(path, "a+b") as f:
            f.truncate(max(nbytes, 1))
        self.vectors = np.memmap(path, dtype=np.float32, mode="r+",
                                 shape=(capacity, self.dim))
        sq = np.zeros((capacity,), np.float32)
        al = np.zeros((capacity,), bool)
        if self.sq_norms is not None:
            n = min(capacity, len(self.sq_norms))
            sq[:n] = self.sq_norms[:n]
            al[:n] = self.alive[:n]
        self.sq_norms, self.alive = sq, al
        self.capacity = capacity
        self._persist_header()

    def _persist_header(self) -> None:
        tmp = os.path.join(self.dir, _HEADER + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"dim": self.dim, "capacity": self.capacity}, f)
        os.replace(tmp, os.path.join(self.dir, _HEADER))

    # -- HostVectorStore API ------------------------------------------------
    def ensure_dim(self, dim: int) -> None:
        if self.dim is None:
            self.dim = dim
            self._map(max(self.capacity, 1024))
        elif self.dim != dim:
            raise ValueError(
                f"embedding dimension mismatch: {self.dim} != {dim}")

    def ensure_capacity(self, needed: int) -> bool:
        if self.vectors is None:
            raise RuntimeError("store dim not set")
        if needed <= self.capacity:
            return False
        new_cap = max(self.capacity, 1024)
        while new_cap < needed:
            new_cap *= 2
        self._map(new_cap)
        return True

    def put(self, slot: int, vec: np.ndarray) -> None:
        vec = np.asarray(vec, np.float32)
        self.ensure_dim(vec.shape[-1])
        self.ensure_capacity(slot + 1)
        self.vectors[slot] = vec
        self.sq_norms[slot] = float(np.dot(vec.astype(np.float64),
                                           vec.astype(np.float64)))
        self.alive[slot] = True

    def put_batch(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        vecs = np.asarray(vecs, np.float32)
        self.ensure_dim(vecs.shape[-1])
        self.ensure_capacity(int(np.max(slots)) + 1 if len(slots) else 0)
        self.vectors[slots] = vecs
        v64 = vecs.astype(np.float64)
        self.sq_norms[slots] = np.sum(v64 * v64, axis=-1).astype(np.float32)
        self.alive[slots] = True

    def kill(self, slot: int) -> None:
        self.alive[slot] = False

    def get(self, slot: int) -> np.ndarray:
        return np.asarray(self.vectors[slot])

    def get_batch(self, slots: np.ndarray) -> np.ndarray:
        """Batched disk fetch (GetVectorsBatch, vector_ops.go:321-432):
        one fancy-index read — page-granular, OS-cached."""
        return np.asarray(self.vectors[np.asarray(slots)])

    def flush(self) -> None:
        """msync data + persist sidecars (the reference's Flush,
        vector_ops.go:98-159)."""
        if self.vectors is not None:
            self.vectors.flush()
        tmp = os.path.join(self.dir, "sidecar.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, sq_norms=self.sq_norms, alive=self.alive)
        os.replace(tmp, os.path.join(self.dir, "sidecar.npz"))
        self._persist_header()

    def close(self) -> None:
        self.flush()
        self.vectors = None
