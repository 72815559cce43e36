"""Streaming exact index (port of hnsw_tpu/index/streaming.py) — serve
N >> device memory (and >> RAM) at recall 1.0.

The reference's answer to datasets bigger than memory is the parquet/
arrow disk graphs (SURVEY.md §2.5-2.6): structure in RAM, vectors on
disk, per-query batched fetches. The answer for the EXACT tier is
simpler and faster: vectors live in one memory-mapped row file
(io/mmap_store.MmapVectorStore); a query batch streams device-sized
chunks through the device — chunk upload, scan, running top-k merge — so
device memory bounds the CHUNK, not the dataset, and host RAM holds only
the page-cache working set.

This is the disk tier of the hybrid family: recall 1.0 at any N, with
throughput bounded by host->device bandwidth instead of device capacity.
Reference role: parquet/vector_ops.go:321-432 (GetVectorsBatch) +
hybrid/exact.go semantics.

Float32 chunks are scanned by ``ops/exact_screen.exact_scan``: on a CUDA
device a chunk of 32,768 rows or more (k <= 120, a built-in metric) goes
through the fused screen kernel K1 (csrc/exact_screen.cu); fewer rows,
larger k, custom metrics and the CPU take the plain chunked scan
``ops/topk.exact_topk``. Here the port departs from the JAX package's
call graph, whose streaming scan calls ``exact_topk`` (XLA) at every
size: the function and the result are the same (f32-exact distances and
order, ties to the lower id), and K1 is the large-N path for the reason
hnsw_tpu/index/exact.py gives (the [Q, N] scores never reach device
memory). Reduced chunks (``stream_dtype``) are scanned by
``ops/exact_screen.capacity_scan``: the capacity screen (K1's kernel
with the chunk's store) on every CUDA chunk up to 256 candidates, the
plain ``ops/topk.quantized_topk_candidates`` elsewhere. They are
reranked in f32 on the host against the mmap store
(``utils/rerank.host_rerank``).

Upload: on CUDA each chunk is cast (on the reduced rungs) and copied from
the memmap into one of two pinned host buffers, then to the device with
``non_blocking=True``. A CUDA event recorded after that copy guards the
buffer, so the host fills chunk c+1 while the device copies and scans
chunk c; the chunk loop holds no other wait on the device. On the CPU
the chunks are plain tensors.
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_dtype, canonical_metric
from hnsw_tpu_torch.core.state import default_device
from hnsw_tpu_torch.io.mmap_store import MmapVectorStore
from hnsw_tpu_torch.ops.distance import INF_DIST
from hnsw_tpu_torch.ops.exact_screen import capacity_scan, exact_scan
from hnsw_tpu_torch.ops.topk import merge_topk
from hnsw_tpu_torch.utils.keystore import SlotMap

#: chunk element type of each stream_dtype
_CHUNK_DTYPE = {"float32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16, "int8": torch.int8}


def cast_rows(raw: np.ndarray, stream_dtype: str, out: torch.Tensor,
              scales: Optional[torch.Tensor] = None,
              scratch: Optional[torch.Tensor] = None) -> None:
    """Write f32 rows ``raw`` [rows, D] into ``out[:rows]`` as
    ``stream_dtype``, the JAX package's host casts: float32 as is, bf16 and
    fp16 rounded to nearest even (as ml_dtypes and numpy round), int8 as
    clip(rint(row / s), -127, 127) with s = absmax / 127 per row (1 for a
    zero row), s written to ``scales[:rows]``. int8 works in ``scratch``
    (f32, at least [rows, D]) when given: a chunk-sized temporary a call
    costs more than the arithmetic."""
    src = torch.from_numpy(np.ascontiguousarray(raw, np.float32))
    rows = src.shape[0]
    if stream_dtype == "int8":
        work = torch.empty_like(src) if scratch is None else scratch[:rows]
        amax = torch.abs(src, out=work).amax(dim=1)
        s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        torch.div(src, s[:, None], out=work)
        out[:rows].copy_(work.round_().clamp_(-127, 127))
        scales[:rows].copy_(s)
    else:
        out[:rows].copy_(src)


class _Staging:
    """Host buffers of chunk uploads. On CUDA: two pinned sets used in
    turn; the host waits for the event recorded after a set's copies to
    the device before it writes that set again. On the CPU: fresh tensors
    for every chunk (they may be pinned in the chunk cache)."""

    def __init__(self, device: torch.device, rows: int, dim: int,
                 stream_dtype: str):
        self.device = device
        self.cuda = device.type == "cuda"
        self.shape = (rows, dim)
        self.dtype = stream_dtype
        self.sets: List[Optional[tuple]] = [None, None]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0
        #: the int8 cast's f32 working rows (see cast_rows)
        self.scratch = (torch.empty(self.shape, dtype=torch.float32)
                        if stream_dtype == "int8" else None)

    def _alloc(self, pin: bool) -> tuple:
        rows, dim = self.shape
        vec = torch.empty((rows, dim), dtype=_CHUNK_DTYPE[self.dtype],
                          pin_memory=pin)
        sq = torch.empty((rows,), dtype=torch.float32, pin_memory=pin)
        alive = torch.empty((rows,), dtype=torch.bool, pin_memory=pin)
        scales = (torch.empty((rows,), dtype=torch.float32, pin_memory=pin)
                  if self.dtype == "int8" else None)
        return vec, sq, alive, scales

    def take(self, m: int) -> tuple:
        """Host buffers (vec, sq, alive, scales or None) of ``m`` rows."""
        if not self.cuda:
            bufs = self._alloc(False)
        else:
            ev = self.events[self.turn]
            if ev is not None:
                ev.synchronize()        # the copy out of this set is done
            if self.sets[self.turn] is None:
                self.sets[self.turn] = self._alloc(True)
            bufs = self.sets[self.turn]
        return tuple(None if b is None else b[:m] for b in bufs)

    def upload(self, bufs: tuple) -> tuple:
        """Queue the copies of ``bufs`` to the device; on CUDA record the
        event that guards them and pass the turn."""
        if not self.cuda:
            return bufs
        out = tuple(None if b is None else b.to(self.device,
                                                non_blocking=True)
                    for b in bufs)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.events[self.turn] = ev
        self.turn ^= 1
        return out


class StreamingExactIndex:
    """Exact k-NN over disk-resident vectors, streamed in device chunks.

    API mirrors ExactIndex (hybrid/exact.go via hybrid.go:15-60);
    storage capacity is the disk, not device memory or RAM. ``chunk_rows``
    bounds device residency: peak device use is one [chunk_rows, D] block
    plus the [Q, k] running winners — unless ``hbm_cache_bytes`` > 0 opts
    into pinning hot chunks (up to that budget) on the device.
    ``stream_dtype`` trades the recall-1.0 guarantee for 2-4x less
    host-to-device traffic on the link-bound cold path (reduced-precision
    chunks + exact f32 host rerank of the nominated pool). ``device``
    (None: the CUDA device, or an error without one) is where chunks are
    scanned and pinned.
    """

    def __init__(self, directory: str, dim: Optional[int] = None,
                 metric: str = "cosine", chunk_rows: int = 131072,
                 fast_math: bool = False,
                 hbm_cache_bytes: int = 0,
                 stream_dtype: str = "float32", device=None):
        self.metric = canonical_metric(metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.slots = SlotMap()
        self.store = MmapVectorStore(directory, dim=dim)
        self.chunk_rows = int(chunk_rows)
        self.fast_math = fast_math
        #: BANDWIDTH mode: cast each chunk on host before upload —
        #: "bf16"/"fp16" halve and "int8" quarter the host-to-device
        #: bytes of the cold path and stretch ``hbm_cache_bytes`` over
        #: 2-4x the working set. The reduced scan nominates k+margin
        #: candidates; ONE host fetch against the f32 mmap store restores
        #: exact ordering (utils/rerank.host_rerank), exactly the
        #: ExactIndex capacity-mode contract — including its
        #: clustered-data caveat (int8 cannot rank tight clusters; fp16
        #: is the tight-cluster 2-byte rung). "float32" (default) keeps
        #: the recall-1.0 guarantee with no rerank.
        stream_dtype = canonical_dtype(
            stream_dtype, ("float32", "bf16", "fp16", "int8"),
            "stream_dtype")
        if (stream_dtype != "float32"
                and self.metric not in ("cosine", "l2", "sqeuclidean",
                                        "dot")):
            raise ValueError(
                "stream_dtype requires a built-in metric "
                "(the reduced scan's epilogue is device-fused)")
        self.stream_dtype = stream_dtype
        self._cache_stream_dtype = stream_dtype
        #: device chunk cache (opt-in, 0 = off): chunks that fit the
        #: budget stay on the device across batches, so a warm working
        #: set serves at device-scan speed and only the cold tail streams
        #: from disk — the reference VectorStore's cache role
        #: (parquet/vector_ops.go:18-63). Mutations through THIS instance
        #: invalidate the owning chunk; do not enable it when another
        #: process/index mutates the same mmap directory (pinned chunks
        #: would go stale).
        self.hbm_cache_bytes = int(hbm_cache_bytes)
        self._cache: dict = {}  # chunk_id -> (vec, sq, alive, scales, nbytes)
        self._cache_bytes = 0

    def _invalidate(self, slots) -> None:
        for s in np.unique(np.asarray(slots, np.int64) // self.chunk_rows):
            ent = self._cache.pop(int(s), None)
            if ent is not None:
                self._cache_bytes -= ent[-1]

    # -- mutation ------------------------------------------------------------
    def add(self, key: Hashable, vector) -> None:
        slot, _ = self.slots.assign(key)
        self.store.put(slot, np.asarray(vector, np.float32))
        self._invalidate([slot])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        if len(keys) != len(vectors):
            raise ValueError("keys/vectors length mismatch")
        slot_list = [self.slots.assign(k)[0] for k in keys]
        self.store.put_batch(np.asarray(slot_list, np.int64), vectors)
        self._invalidate(slot_list)

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.release(key)
        if slot is None:
            return False
        self.store.kill(slot)
        self._invalidate([slot])
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    def __len__(self) -> int:
        return len(self.slots)

    def flush(self) -> None:
        self.store.flush()

    def close(self) -> None:
        self._cache.clear()
        self._cache_bytes = 0
        self.store.close()

    # -- search ---------------------------------------------------------------
    def _stage_chunk(self, c0: int, c1: int, staging: _Staging) -> tuple:
        """Rows [c0, c1) padded to a multiple of 8 (pad rows dead), cast
        to the stream dtype and queued for the device: (vec, sq, alive,
        scales or None)."""
        rows = c1 - c0
        m = rows + (-rows) % 8
        vec, sq, alive, scales = staging.take(m)
        cast_rows(self.store.vectors[c0:c1], self.stream_dtype, vec, scales,
                  staging.scratch)
        sq[:rows].copy_(torch.from_numpy(self.store.sq_norms[c0:c1]))
        alive[:rows].copy_(torch.from_numpy(self.store.alive[c0:c1]))
        if m > rows:
            vec[rows:].zero_()
            sq[rows:].zero_()
            alive[rows:].zero_()
            if scales is not None:
                scales[rows:].zero_()
        return staging.upload((vec, sq, alive, scales))

    def batch_search_slots(self, queries: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        nq = queries.shape[0]
        n = self.slots.capacity_used
        if n == 0:
            return (np.full((nq, k), INF_DIST, np.float32),
                    np.full((nq, k), -1, np.int64))
        self.store.ensure_dim(queries.shape[-1])
        rd = self.stream_dtype
        if self._cache_stream_dtype != rd:      # mode changed: drop pins
            self._cache.clear()
            self._cache_bytes = 0
            self._cache_stream_dtype = rd
        reduced = rd != "float32"
        # running-merge width: the reduced scan keeps k+margin
        # candidates per chunk so the final f32 host rerank has the
        # same containment margin as ExactIndex's capacity modes
        if reduced:
            margin = max(16, k // 2) if rd == "int8" else max(4, k // 8)
            width = min(k + margin, n)
        else:
            width = k
        dev = self.device
        step = self.chunk_rows
        widest = min(step, n)
        staging = _Staging(dev, widest + (-widest) % 8, self.store.dim, rd)
        qd = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        best_d = torch.full((nq, width), INF_DIST, dtype=torch.float32,
                            device=dev)
        best_i = torch.full((nq, width), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, n, step):
            c1 = min(c0 + step, n)
            rows = c1 - c0
            cached = self._cache.get(c0 // step)
            if cached is not None and cached[0].shape[0] >= rows:
                vd, sd, ad, scd = cached[:4]
            else:
                vd, sd, ad, scd = self._stage_chunk(c0, c1, staging)
                # pin full chunks while the budget lasts (the last,
                # partial chunk regrows — don't pin a short version)
                nbytes = sum(t.numel() * t.element_size()
                             for t in (vd, sd, ad, scd) if t is not None)
                if (rows == step
                        and self._cache_bytes + nbytes
                        <= self.hbm_cache_bytes):
                    self._cache[c0 // step] = (vd, sd, ad, scd, nbytes)
                    self._cache_bytes += nbytes
            if reduced:
                d, i = capacity_scan(
                    qd, vd, scd, sd, ad, kk=min(width, rows),
                    metric=self.metric)
            else:
                d, i = exact_scan(qd, vd, sd, ad, k=min(width, rows),
                                  metric=self.metric,
                                  fast_math=self.fast_math)
            if d.shape[1] < width:
                d = torch.nn.functional.pad(d, (0, width - d.shape[1]),
                                            value=float(INF_DIST))
                i = torch.nn.functional.pad(i, (0, width - i.shape[1]),
                                            value=-1)
            i = torch.where(i >= 0, i + c0, -1)
            best_d, best_i = merge_topk(best_d, best_i, d, i, width)
        best_i = torch.where(best_d >= INF_DIST, -1, best_i)
        best_d, best_i = best_d.cpu().numpy(), best_i.cpu().numpy()
        if reduced:
            # one batched f32 fetch from the mmap store restores exact
            # ordering of the nominated pool (dead/pad rows masked)
            from hnsw_tpu_torch.utils.rerank import host_rerank
            return host_rerank(self.store, self.metric, queries, best_i, k)
        return best_d, best_i

    def batch_search(self, queries, k: int
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        d, i = self.batch_search_slots(np.asarray(queries, np.float32), k)
        keys = [self.slots.keys_for(row) for row in i]
        return keys, d

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        d, i = self.batch_search_slots(
            np.asarray(query, np.float32)[None], k)
        return [(self.slots.key_of(int(s)), float(dd))
                for dd, s in zip(d[0], i[0]) if s >= 0]
