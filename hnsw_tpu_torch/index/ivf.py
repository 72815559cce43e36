"""IVF (inverted-file) index (port of hnsw_tpu/index/ivf.py) — the
large-N strategy built from matmuls.

The reference routes candidates through LSH buckets and k-means
partitions (hybrid/partitioner.go, hybrid/lsh.go) but still scores one
query at a time. This index is the same idea in batched form:

  * k-means centroids trained on the device (chunked distance matmuls +
    one-hot segment sums);
  * vectors laid out PARTITION-MAJOR in a padded [NB, bs, D] block
    tensor — per-partition scans are contiguous, no row gathers;
  * a query batch probes its top-nprobe partitions: queries are grouped
    by block on the host, then ONE batched einsum scores every
    (block, its-queries, its-vectors) triple, and a per-query top-k
    merges the probed blocks' candidates.

Work scales with nprobe/P of the exact scan while staying all matmul.
"""

from __future__ import annotations

from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric
from hnsw_tpu_torch.core.state import bucket_pow2, default_device, upload
from hnsw_tpu_torch.ops.distance import (DEFAULT, INF_DIST, np_gram_epilogue,
                                         pairwise_dist)
from hnsw_tpu_torch.ops.topk import topk_smallest
from hnsw_tpu_torch.utils.keystore import HostVectorStore, SlotMap

#: rows of one assignment / k-means chunk (bounds the [ch, P] distance
#: block and its one-hot twin)
_ASSIGN_CHUNK = 65536
#: host bytes staged per copy of _gathered_block_put
_PUT_CHUNK_BYTES = 64 << 20
#: device bytes of one [blocks, Qp, C] f32 score block of _scan_blocks;
#: the stable sort behind it holds about three more of the same size
_SCAN_BYTES = 1 << 30


def _gathered_block_put(vectors: np.ndarray, block_slot: np.ndarray,
                        block_valid: np.ndarray, bs: int, dim: int,
                        device) -> torch.Tensor:
    """Assemble the padded [NB, bs, dim] f32 block table on ``device``
    from host ``vectors`` without ever materializing the padded host
    copy: bounded host chunks (gathered rows for a run of blocks) are
    staged in one reused host buffer (pinned for a CUDA device) and
    copied into the preallocated device tensor."""
    device = torch.device(device)
    NB = block_slot.shape[0]
    buf = torch.zeros((NB, bs, dim), dtype=torch.float32, device=device)
    step = min(max(1, _PUT_CHUNK_BYTES // (bs * dim * 4)), max(NB, 1))
    stage = torch.zeros((step, bs, dim), dtype=torch.float32,
                        pin_memory=device.type == "cuda")
    chunk = stage.numpy()
    for c0 in range(0, NB, step):
        m = min(step, NB - c0)
        sl = np.clip(block_slot[c0:c0 + m], 0, None)
        chunk[:m] = vectors[sl]
        chunk[:m][~block_valid[c0:c0 + m]] = 0
        # a blocking copy: the staging buffer is refilled next turn
        buf[c0:c0 + m].copy_(stage[:m])
    return buf


def _merge_probed(dk, ck, block_slot, pp, rr, valid, *, k: int):
    """Per-query merge of probed block results, on the device.

    dk/ck: [NB, Qp, kk]; block_slot: [NB, bs]; pp/rr: [Q, T] (block id,
    row-in-block) per probed block; valid: [Q, T].
    Returns (dists [Q, k], slots [Q, k] int64) — the only payload that
    leaves the device.
    """
    inf = float(INF_DIST)
    d_sel = torch.where(valid[:, :, None], dk[pp, rr], inf)   # [Q, T, kk]
    c_sel = ck[pp, rr]
    s_sel = block_slot[pp[:, :, None], torch.clamp(c_sel, min=0)].long()
    Q = pp.shape[0]
    d_all = d_sel.reshape(Q, -1)
    s_all = torch.where(d_sel < inf / 2, s_sel, -1).reshape(Q, -1)
    kk = min(k, d_all.shape[1])
    dd, pos = topk_smallest(d_all, kk)
    ss = torch.gather(s_all, 1, pos)
    return dd, torch.where(dd < inf / 2, ss, -1)


def _assign_parts(vectors: torch.Tensor, cents: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """Nearest-centroid assignment, chunked on the device ([N] int32; the
    first centroid wins a tie).

    Chunking keeps the [ch, P] distance block small; DEFAULT precision
    (bf16-rounded operands) is fine for partition routing.
    """
    out = [torch.argmin(pairwise_dist(vectors[c0:c0 + _ASSIGN_CHUNK], cents,
                                      metric=metric, precision=DEFAULT),
                        dim=1).to(torch.int32)
           for c0 in range(0, vectors.shape[0], _ASSIGN_CHUNK)]
    return torch.cat(out) if out else torch.zeros(
        (0,), dtype=torch.int32, device=vectors.device)


def _kmeans_step(vectors: torch.Tensor, cents: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """One Lloyd's iteration, fully device-resident.

    vectors [N, D], cents [P, D]. Assignment and the segment sums are
    chunked matmuls; only the updated [P, D] table leaves the step. The
    sums are a one-hot f32 matmul, not ``index_add_``: the matmul gives
    the same sums every run, atomics on CUDA do not.
    """
    p, d = cents.shape
    sums = torch.zeros((p, d), dtype=torch.float32, device=cents.device)
    counts = torch.zeros((p,), dtype=torch.float32, device=cents.device)
    for c0 in range(0, vectors.shape[0], _ASSIGN_CHUNK):
        chunk = vectors[c0:c0 + _ASSIGN_CHUNK].to(torch.float32)
        dist = pairwise_dist(chunk, cents, metric=metric, precision=DEFAULT)
        oh = torch.nn.functional.one_hot(torch.argmin(dist, dim=1),
                                         p).to(torch.float32)
        sums += oh.T @ chunk
        counts += oh.sum(dim=0)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, cents)


def _device_assign(vectors: np.ndarray, cents: np.ndarray, metric: str,
                   device) -> np.ndarray:
    """Host wrapper: assign on ``device``, one bounded chunk of rows on
    the device at a time."""
    c_dev = torch.from_numpy(np.ascontiguousarray(cents, np.float32)
                             ).to(device)
    out = [_assign_parts(torch.from_numpy(np.ascontiguousarray(
        vectors[c0:c0 + _ASSIGN_CHUNK], np.float32)).to(device), c_dev,
        metric).cpu().numpy()
        for c0 in range(0, vectors.shape[0], _ASSIGN_CHUNK)]
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def _scan_blocks(queries, q_rows, blocks, block_sq, block_valid,
                 metric: str, k: int):
    """Score grouped queries against their partition blocks.

    queries:    [Q, D]
    q_rows:     [NB, Qp] int32 query indices probing block b (-1 pad)
    blocks:     [NB, C, D]; block_sq [NB, C]; block_valid [NB, C]
    returns (dists [NB, Qp, k'], cols [NB, Qp, k']), k' = min(k, C)

    The product runs at HIGHEST: the probed scan IS the final ranking (no
    rerank stage), and bf16 operands cannot order near-ties inside tight
    clusters. The [nb, Qp, C] score block lives in device memory, so the
    blocks are taken in runs of at most _SCAN_BYTES of scores.
    """
    inf = float(INF_DIST)
    NB, C, _ = blocks.shape
    Qp = q_rows.shape[1]
    q_sq_all = torch.sum(queries * queries, dim=-1)
    kk = min(k, C)
    step = max(1, _SCAN_BYTES // max(1, Qp * C * 4))
    dks, cks = [], []
    for b0 in range(0, NB, step):
        rows = q_rows[b0:b0 + step]
        safe = torch.clamp(rows, 0, queries.shape[0] - 1).long()
        qg = queries[safe]                                   # [nb, Qp, D]
        gram = torch.einsum("pqd,pcd->pqc", qg, blocks[b0:b0 + step])
        q_sq = q_sq_all[safe]                                # [nb, Qp]
        b_sq = block_sq[b0:b0 + step]
        if metric == "cosine":
            d = 1.0 - gram * torch.rsqrt(
                q_sq[:, :, None] * b_sq[:, None, :] + 1e-30)
        elif metric == "dot":
            d = -gram
        else:
            d = torch.clamp_min(q_sq[:, :, None] + b_sq[:, None, :]
                                - 2.0 * gram, 0.0)
            if metric == "l2":
                d = torch.sqrt(d)
        d = torch.where(block_valid[b0:b0 + step, None, :], d, inf)
        d = torch.where((rows >= 0)[:, :, None], d, inf)
        dk, ck = topk_smallest(d, kk)
        dks.append(dk)
        cks.append(ck)
    if len(dks) == 1:
        return dks[0], cks[0]
    return torch.cat(dks), torch.cat(cks)


class IVFIndex:
    """Partition-scanned ANN index (all-matmul)."""

    def __init__(self, num_partitions: int = 64,
                 nprobe: "int | str" = "auto",
                 metric: str = "cosine", seed: int = 42,
                 kmeans_iters: int = 10, auto_recall: float = 0.9,
                 device=None):
        """``nprobe`` — partitions probed per query. An int fixes it;
        "auto" (default) calibrates the smallest nprobe meeting
        ``auto_recall`` against a sampled exact oracle over the index's
        own data, re-measured when the index grows/shrinks >25%
        (unclustered data needs a high nprobe, and a fixed one serves
        low recall there without telling the caller). ``device``: where
        the block table lives and the scans run (default: the CUDA
        device; raises without one)."""
        if isinstance(nprobe, str):
            if nprobe != "auto":
                raise ValueError(f"bad nprobe {nprobe!r}")
        elif nprobe > num_partitions:
            raise ValueError("nprobe must be <= num_partitions")
        self.P = num_partitions
        self.nprobe = nprobe
        self.auto_recall = float(auto_recall)
        #: (resolved nprobe, index size at calibration)
        self._auto_cache: Optional[Tuple[int, int]] = None
        self.metric = canonical_metric(metric)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.slots = SlotMap()
        self.centroids: Optional[np.ndarray] = None
        # partition-major storage (host authoritative, device mirror).
        # Vectors live in a dense padded store and membership in
        # per-partition slot sets + a slot->partition map, so _sync and
        # delete are vectorized / O(1) instead of Python-looped over N.
        self.store = HostVectorStore()
        self._members: List[set] = [set() for _ in range(self.P)]
        self._part_of: dict = {}
        self._dirty = True
        self._dev = None
        self._dev_slots: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self.slots)

    def close(self) -> None:
        """Drop the device tables; the next search rebuilds them."""
        self._dev = None
        self._dev_slots = None

    # -- training -------------------------------------------------------------
    def _train(self, vectors: np.ndarray) -> np.ndarray:
        """Device k-means (Lloyd's): everything stays on the device; only
        the final [P, D] centroid table comes back."""
        rng = np.random.default_rng(self.seed)
        n = vectors.shape[0]
        init = rng.choice(n, size=min(self.P, n), replace=False)
        cents = vectors[init].copy()
        if len(cents) < self.P:  # fewer points than partitions
            extra = rng.standard_normal(
                (self.P - len(cents), vectors.shape[1])).astype(np.float32)
            cents = np.concatenate([cents, extra])
        v_dev = upload(np.asarray(vectors, np.float32), 0.0,
                       (n, vectors.shape[1]), self.device)
        c_dev = torch.from_numpy(cents.astype(np.float32)).to(self.device)
        for _ in range(self.kmeans_iters):
            c_dev = _kmeans_step(v_dev, c_dev, self.metric)
        return c_dev.cpu().numpy()

    # -- mutation ----------------------------------------------------------------
    def build(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate keys in build batch")
        self.centroids = self._train(vectors)
        assign = _device_assign(vectors, self.centroids, self.metric,
                                self.device)
        self._commit(keys, vectors, assign)

    def add(self, key: Hashable, vector) -> None:
        self.batch_add([key], np.asarray(vector, np.float32)[None])

    def batch_add(self, keys: Sequence[Hashable], vectors) -> None:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if self.centroids is None:
            self.build(keys, vectors)
            return
        assign = _device_assign(vectors, self.centroids, self.metric,
                                self.device)
        self._commit(keys, vectors, assign)

    def _commit(self, keys, vectors, assign) -> None:
        for k_ in keys:
            if k_ in self.slots:
                self.delete(k_)
        slot_arr = np.asarray([self.slots.assign(k_)[0] for k_ in keys],
                              np.int64)
        self.store.put_batch(slot_arr, vectors)
        for slot, p in zip(slot_arr, assign):
            self._members[int(p)].add(int(slot))
            self._part_of[int(slot)] = int(p)
        self._dirty = True

    def delete(self, key: Hashable) -> bool:
        slot = self.slots.slot_of(key)
        if slot is None:
            return False
        self.slots.release(key)
        self.store.kill(slot)
        p = self._part_of.pop(slot, None)
        if p is not None:
            self._members[p].discard(slot)
        self._dirty = True
        return True

    def batch_delete(self, keys: Sequence[Hashable]) -> List[bool]:
        return [self.delete(k) for k in keys]

    # -- device layout --------------------------------------------------------------
    #: fixed block size: partitions split into [*, BS] chunks so scan
    #: work tracks TRUE partition sizes instead of the max (skewed
    #: partitions otherwise pad every partition to the largest, which
    #: can make IVF slower than the exact scan on clustered data).
    BLOCK = 1024

    def _sync(self):
        if not self._dirty and self._dev is not None:
            return self._dev
        self._dev = None                     # free the old tables first
        self._dev_slots = None
        dim = self.store.dim or 1
        sizes = [len(m) for m in self._members]
        bs = min(self.BLOCK, bucket_pow2(max(max(sizes, default=1), 1), 8))
        # partition -> list of block indices
        part_blocks: List[List[int]] = [[] for _ in range(self.P)]
        rows = []
        for p, mem in enumerate(self._members):
            mem_arr = np.fromiter(mem, np.int64, len(mem))
            for c0 in range(0, max(len(mem_arr), 1), bs):
                part_blocks[p].append(len(rows))
                rows.append((p, mem_arr[c0:c0 + bs]))
        NB = len(rows)
        block_sq = np.zeros((NB, bs), np.float32)
        block_valid = np.zeros((NB, bs), bool)
        block_slot = np.full((NB, bs), -1, np.int64)
        for b, (p, mem_arr) in enumerate(rows):
            w = len(mem_arr)
            if w == 0:
                continue
            block_sq[b, :w] = self.store.sq_norms[mem_arr]
            block_valid[b, :w] = True
            block_slot[b, :w] = mem_arr
        dev = self.device
        # int32: slots are dense and < 2^30 by construction
        self._dev_slots = torch.from_numpy(
            block_slot.astype(np.int32)).to(dev)
        # blocks is the GB-scale padded table (NB x bs x D f32): it is
        # assembled in BOUNDED host chunks copied into a preallocated
        # device tensor, never as one padded host array
        blocks_dev = _gathered_block_put(self.store.vectors, block_slot,
                                         block_valid, bs, dim, dev)
        self._dev = (blocks_dev, torch.from_numpy(block_sq).to(dev),
                     torch.from_numpy(block_valid).to(dev), block_slot,
                     torch.from_numpy(np.ascontiguousarray(
                         self.centroids, np.float32)).to(dev), part_blocks)
        self._dirty = False
        return self._dev

    # -- auto-nprobe -----------------------------------------------------------------
    def _resolve_nprobe(self) -> int:
        """Effective nprobe: the configured int, or the cached/auto
        calibrated value (re-measured when the index size drifts >25%
        from the calibration point)."""
        if not isinstance(self.nprobe, str):
            return int(self.nprobe)
        n = len(self.slots)
        c = self._auto_cache
        if c is not None and c[1] > 0 and abs(n - c[1]) <= 0.25 * c[1]:
            return c[0]
        npb = self._calibrate_nprobe()
        self._auto_cache = (npb, max(n, 1))
        return npb

    def _calibrate_nprobe(self, k: int = 10, sample: int = 32) -> int:
        """Smallest nprobe meeting ``auto_recall`` on member-derived
        probe queries vs a full exact oracle over the live store.

        Probes are perturbed OFF-node (0.85 member + 0.15 other-member
        mix — raw member probes anchor their own partition and
        over-estimate recall; same physics as HybridIndex.calibrate's
        finding). The oracle is a chunked host numpy scan of ~32 probes
        x N rows."""
        live = np.fromiter(self._part_of.keys(), np.int64,
                           len(self._part_of))
        n = len(live)
        if n <= 4 * k:
            return self.P          # tiny index: just scan everything
        rng = np.random.default_rng(self.seed + 1)
        pick = rng.choice(live, size=min(sample, n), replace=False)
        mix = rng.choice(live, size=len(pick))
        queries = np.asarray(0.85 * self.store.vectors[pick]
                             + 0.15 * self.store.vectors[mix], np.float32)
        q_sq = np.sum(queries * queries, axis=1)
        P_, kk = len(queries), min(k, n)
        gd = np.full((P_, kk), np.inf, np.float32)
        gi = np.full((P_, kk), -1, np.int64)
        for c0 in range(0, n, 131072):
            chunk_slots = live[c0:c0 + 131072]
            mat = self.store.vectors[chunk_slots]
            qv = queries @ mat.T
            d = np_gram_epilogue(
                qv, q_sq[:, None],
                self.store.sq_norms[chunk_slots][None], self.metric
            ).astype(np.float32)
            cat_d = np.concatenate([gd, d], axis=1)
            cat_i = np.concatenate(
                [gi, np.broadcast_to(chunk_slots, (P_, len(chunk_slots)))],
                axis=1)
            part = np.argpartition(cat_d, kk - 1, axis=1)[:, :kk]
            gd = np.take_along_axis(cat_d, part, axis=1)
            gi = np.take_along_axis(cat_i, part, axis=1)
        gts = [set(self.slots.keys_for(row)) - {None} for row in gi]
        total = sum(len(g) for g in gts) or 1
        npb = 1
        while npb <= self.P:
            keys, _ = self.batch_search(queries, kk, _nprobe=min(npb,
                                                                 self.P))
            hits = sum(len({kx for kx in row if kx is not None} & g)
                       for row, g in zip(keys, gts))
            if hits / total >= self.auto_recall:
                return min(npb, self.P)
            npb *= 2
        return self.P

    # -- search ----------------------------------------------------------------------
    def batch_search(self, queries, k: int, *,
                     _nprobe: Optional[int] = None
                     ) -> Tuple[List[List[Any]], np.ndarray]:
        if k <= 0:
            raise ValueError(f"k must be greater than 0, got {k}")
        queries = np.atleast_2d(np.ascontiguousarray(queries, np.float32))
        Q = queries.shape[0]
        if len(self.slots) == 0:
            return ([[None] * k for _ in range(Q)],
                    np.full((Q, k), INF_DIST, np.float32))
        npb = _nprobe if _nprobe is not None else self._resolve_nprobe()
        (blocks, block_sq, block_valid, block_slot, cents,
         part_blocks) = self._sync()
        dev = self.device

        # 1. probe assignment (one [Q, P] matmul)
        q_dev = torch.from_numpy(queries).to(dev)
        cd = pairwise_dist(q_dev, cents, metric=self.metric).cpu().numpy()
        probe = np.argpartition(cd, min(npb, self.P) - 1,
                                axis=1)[:, :npb]              # [Q, nprobe]

        # 2. group queries by BLOCK (host)
        q_rows, probe_pos = self._group_by_block(probe, part_blocks,
                                                 blocks.shape[0])

        # 3. one batched scan of all probed blocks (device-resident)
        dk, ck = _scan_blocks(q_dev, torch.from_numpy(q_rows).to(dev),
                              blocks, block_sq, block_valid,
                              self.metric, k)

        # 4. per-query merge on the device; only [Q, k] comes back
        pp, rr, valid_t = self._merge_positions(probe_pos)
        dd, ss = _merge_probed(dk, ck, self._dev_slots,
                               torch.from_numpy(pp).to(dev),
                               torch.from_numpy(rr).to(dev),
                               torch.from_numpy(valid_t).to(dev), k=k)
        dd = dd.cpu().numpy()
        ss = ss.cpu().numpy()
        keys = [self.slots.keys_for(row) for row in ss]
        if dd.shape[1] < k:
            pad = k - dd.shape[1]
            dd = np.pad(dd, ((0, 0), (0, pad)), constant_values=INF_DIST)
            for row in keys:
                row.extend([None] * pad)
        return keys, dd.astype(np.float32)

    @staticmethod
    def _group_by_block(probe: np.ndarray, part_blocks, NB: int):
        """Step 2 of batch_search, a host loop over queries and probed
        blocks: (q_rows [NB, Qp] int32, the query scanned in each row of
        each block, -1 = none; probe_pos, per query its (block, row)
        positions in that table)."""
        Q = probe.shape[0]
        per_block: List[List[int]] = [[] for _ in range(NB)]
        probe_pos: List[List[Tuple[int, int]]] = [[] for _ in range(Q)]
        for qi in range(Q):
            for p in probe[qi]:
                for b in part_blocks[int(p)]:
                    probe_pos[qi].append((b, len(per_block[b])))
                    per_block[b].append(qi)
        qp_max = bucket_pow2(max(max((len(x) for x in per_block),
                                     default=1), 1), 8)
        q_rows = np.full((NB, qp_max), -1, np.int32)
        for b, lst in enumerate(per_block):
            q_rows[b, :len(lst)] = lst
        return q_rows, probe_pos

    @staticmethod
    def _merge_positions(probe_pos):
        """Step 4's host half: probe_pos as padded [Q, T] arrays of block
        and row numbers with their validity mask."""
        Q = len(probe_pos)
        t_max = bucket_pow2(max(len(x) for x in probe_pos), 4)
        pp = np.zeros((Q, t_max), np.int64)
        rr = np.zeros((Q, t_max), np.int64)
        valid_t = np.zeros((Q, t_max), bool)
        for qi, lst in enumerate(probe_pos):
            for j, (b, r) in enumerate(lst):
                pp[qi, j] = b
                rr[qi, j] = r
                valid_t[qi, j] = True
        return pp, rr, valid_t

    def search(self, query, k: int) -> List[Tuple[Any, float]]:
        keys, dists = self.batch_search(
            np.asarray(query, np.float32)[None], k)
        return [(kk, float(dd)) for kk, dd in zip(keys[0], dists[0])
                if kk is not None]

    def stats(self) -> dict:
        sizes = [len(m) for m in self._members]
        return {"num_partitions": self.P, "nprobe": self.nprobe,
                "sizes_max": max(sizes), "sizes_min": min(sizes),
                "total": sum(sizes)}

    def calibration_state(self) -> dict:
        """JSON-able auto-nprobe calibration snapshot (persist through
        a serving wrapper's metadata: a reopened large index must not
        re-pay the calibration oracle scan)."""
        if self._auto_cache is None:
            return {}
        npb, n = self._auto_cache
        return {"auto_nprobe": [int(npb), int(n)]}

    def restore_calibration(self, state: Optional[dict]) -> None:
        """Inverse of calibration_state (no-op on None/empty). The
        >25% size-drift check in _resolve_nprobe re-measures stale
        restores automatically."""
        if state and state.get("auto_nprobe"):
            npb, n = state["auto_nprobe"]
            self._auto_cache = (int(npb), int(n))
