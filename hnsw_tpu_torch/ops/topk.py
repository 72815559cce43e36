"""Top-k selection ops (port of hnsw_tpu/ops/topk.py).

Tie order: the JAX package relies on ``lax.top_k`` returning the lower
index first among equal values. ``torch.topk`` promises no tie order, so
every selection here is a stable ascending ``torch.sort``, a
``torch.topk`` over unique int64 keys (``topk_keyed``), or a float32
``torch.topk`` whose boundary ties are settled by those keys
(``topk_lowest_ids``).

Exact search over large N streams the score matrix in chunks with a
running top-k merge (O(Q*(k+chunk)) memory instead of O(Q*N)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hnsw_tpu_torch.ops.distance import (HIGHEST, INF_DIST, _epilogue,
                                         bf16_round, gathered_dist,
                                         pairwise_dist)


def topk_smallest(dists: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis, ties to the lower index.
    Returns (dists [.., k], idx [.., k])."""
    d, idx = torch.sort(dists, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def topk_keyed(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of float32 ``dists`` [Q, C] along the last axis, ties to
    the lower id: ``torch.topk`` over unique int64 keys (order-preserving
    int32 of the distance high, the id low, as the CUDA screen packs
    them), so the selection costs a top-k, not a sort. ``ids`` [C] or
    [Q, C], each in [0, 2^32). Returns (dists [Q, k], ids [Q, k] int64),
    ascending."""
    bits = dists.contiguous().view(torch.int32)
    mono = torch.where(bits >= 0, bits, torch.iinfo(torch.int32).min - bits)
    keys = (mono.to(torch.int64) << 32) | ids.to(torch.int64)
    top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    low = top & 0xFFFFFFFF
    hi = (top >> 32).to(torch.int32)
    d = torch.where(hi >= 0, hi, torch.iinfo(torch.int32).min - hi)
    return d.view(torch.float32), low


def topk_lowest_ids(dists: torch.Tensor, ids: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_keyed``'s result at about the cost of a float32
    ``torch.topk``: the k + 1 smallest distances; a row whose (k+1)-th
    equals its k-th has a tie that the top-k may cut either way, and only
    such rows are selected again by ``topk_keyed``. The winners are
    ordered by (distance, id). Syncs with the device once, to find those
    rows."""
    c = dists.shape[-1]
    d, pos = torch.topk(dists, min(k + 1, c), dim=-1, largest=False,
                        sorted=True)
    cut = d[:, k] == d[:, k - 1] if c > k else torch.zeros_like(d[:, 0],
                                                               dtype=bool)
    d, pos = d[:, :k], pos[:, :k]
    i = ids[pos] if ids.dim() == 1 else torch.gather(ids, 1, pos)
    if bool(cut.any()):
        rows = cut.nonzero()[:, 0]
        rd, ri = topk_keyed(dists[rows], ids if ids.dim() == 1 else ids[rows],
                            k)
        d = d.index_copy(0, rows, rd)
        i = i.index_copy(0, rows, ri)
    i, o = torch.sort(i, dim=-1)
    d, o2 = torch.sort(torch.gather(d, 1, o), dim=-1, stable=True)
    return d, torch.gather(i, 1, o2)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two top-k candidate sets (per row) into one top-k; on equal
    distances the entries of ``a`` come first."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    dk, pos = topk_smallest(d, k)
    return dk, torch.gather(i, -1, pos)


def exact_topk(queries: torch.Tensor, vectors: torch.Tensor,
               v_sq: torch.Tensor, valid: torch.Tensor,
               k: int, metric: str = "cosine",
               chunk: int = 16384, fast_math: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: brute-force scan of all vectors in chunks.

    queries: [Q, D]; vectors: [N, D]; v_sq: [N]; valid: [N] bool.
    Returns (dists [Q, k], indices [Q, k] int64); invalid rows get
    INF_DIST/-1.

    ``fast_math`` scans with bf16-rounded operands over a widened
    candidate set (k + max(4, k // 8)) and reranks the winners in f32.
    The JAX package selects per-chunk winners with the TPU's
    ``approx_min_k``; there is no such primitive here, so each chunk's
    selection is exact and its ``recall_target`` has no meaning on the
    GPU. Chunks are slices of the table, never padded copies of it.
    """
    n = vectors.shape[0]
    q = queries.to(torch.float32)
    q_sq = torch.sum(q * q, dim=-1)
    if fast_math:
        k_scan = min(k + max(4, k // 8), n)
        chunk = 65536 if q.shape[0] <= 8192 else 32768
        q_bf = bf16_round(q)
    else:
        k_scan = k
    kk = min(k_scan, n)

    dk = ik = None
    for c0 in range(0, n, chunk):
        vec = vectors[c0:c0 + chunk].to(torch.float32)
        sq = v_sq[c0:c0 + chunk]
        if fast_math:
            d = _epilogue(metric, q_bf @ bf16_round(vec).T, q_sq, sq)
        else:
            d = pairwise_dist(q, vec, v_sq=sq, q_sq=q_sq, metric=metric)
        d = torch.where(valid[c0:c0 + chunk][None, :], d, INF_DIST)
        cd, ci = topk_smallest(d, min(kk, d.shape[1]))
        ci = ci + c0
        if dk is None:
            dk, ik = cd, ci
        else:
            dk, ik = merge_topk(dk, ik, cd, ci, kk)

    if fast_math:
        # f32 rerank of the widened bf16 pool -> exact final ordering.
        # Rows whose selected distance was INF are masked-out candidates;
        # they must not be resurrected by recomputing their distance.
        was_masked = dk >= INF_DIST
        safe = torch.clamp(ik, 0, n - 1)
        d = gathered_dist(q, vectors[safe].to(torch.float32), v_sq[safe],
                          q_sq, metric=metric, precision=HIGHEST)
        d = torch.where((ik >= 0) & ~was_masked, d, INF_DIST)
        dk, pos = topk_smallest(d, min(k, d.shape[1]))
        ik = torch.gather(ik, 1, pos)

    if k > dk.shape[1]:  # pad when fewer vectors than k
        pad = k - dk.shape[1]
        dk = torch.nn.functional.pad(dk, (0, pad), value=float(INF_DIST))
        ik = torch.nn.functional.pad(ik, (0, pad), value=-1)
    dk, ik = dk[:, :k], ik[:, :k]
    ik = torch.where(dk >= INF_DIST, -1, ik)
    return dk, ik


def quantized_topk_candidates(queries: torch.Tensor, table: torch.Tensor,
                              scales: Optional[torch.Tensor],
                              v_sq: torch.Tensor, valid: torch.Tensor,
                              kk: int, metric: str = "cosine",
                              chunk: int = 65536
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-kk candidate scan over a reduced-precision table — the exact
    tier's capacity mode (ExactIndex hbm_dtype) — in plain torch: the
    plain version of the capacity screen (``ops/exact_screen.
    capacity_scan``), which runs it on the CPU, in the tests and off
    ``capacity_applies``.

    ``table`` is [N, D] bfloat16 or float16 (scales=None), or int8 with
    per-row ``scales`` [N] f32 such that row ~= row_int8 * scale. Per
    chunk of ``chunk`` rows:

    * int8: the tile is upcast (exactly bf16 values), the queries are
      rounded to bf16, the Gram is summed in f32 and multiplied by the
      per-row scale in the epilogue;
    * float16: the tile is upcast to f32 and scored at HIGH (f32
      products and sums; queries stay f32);
    * bfloat16: both operands bf16-rounded, f32 sums.

    ``v_sq`` holds the exact f32 squared norms. The selection is exact
    and deterministic: a float32 top-k of each chunk with its boundary
    ties settled by id (``topk_lowest_ids``), then a top-k over unique
    (distance, id) keys of the stacked winners (``topk_keyed``), so
    equal distances go to the lower id, as in the kernel and in the JAX
    package's CPU path (``lax.top_k``; on a TPU it selects each chunk
    with ``approx_min_k``, which has no counterpart here).
    Chunks are views of the table, never padded copies of it.

    Returns (dists [Q, kk'], indices [Q, kk'] int64), kk' = min(kk, N),
    ascending, masked or missing slots (INF_DIST, -1); callers restore
    exact ordering with a host f32 rerank (utils/rerank.host_rerank).
    """
    n = table.shape[0]
    q = queries.to(torch.float32)
    q_sq = torch.sum(q * q, dim=-1)
    fp16 = scales is None and table.dtype == torch.float16
    q_op = q if fp16 else bf16_round(q)
    kk = min(kk, n)
    dks, iks = [], []
    for c0 in range(0, n, chunk):
        tab = table[c0:c0 + chunk].to(torch.float32)
        gram = q_op @ tab.T
        if scales is not None:
            gram = gram * scales[c0:c0 + chunk][None, :]
        d = _epilogue(metric, gram, q_sq, v_sq[c0:c0 + chunk])
        d = torch.where(valid[c0:c0 + chunk][None, :], d, float(INF_DIST))
        ids = torch.arange(c0, c0 + d.shape[1], device=d.device)
        dm, im = topk_lowest_ids(d, ids, min(kk, d.shape[1]))
        dks.append(dm)
        iks.append(im)
    dk, ik = topk_keyed(torch.cat(dks, dim=1), torch.cat(iks, dim=1), kk)
    return dk, torch.where(dk >= INF_DIST, -1, ik)


def np_exact_topk(queries: np.ndarray, vectors: np.ndarray, k: int,
                  metric: str = "cosine") -> Tuple[np.ndarray, np.ndarray]:
    """Host-side exact k-NN oracle (ground truth for recall harnesses,
    mirroring hybrid/benchmark_test.go:273's pattern)."""
    from hnsw_tpu_torch.ops.distance import np_pairwise_dist
    d = np_pairwise_dist(queries, vectors, metric)
    k = min(k, vectors.shape[0])
    idx = np.argpartition(d, k - 1, axis=1)[:, :k]
    dd = np.take_along_axis(d, idx, axis=1)
    order = np.argsort(dd, axis=1, kind="stable")
    return np.take_along_axis(dd, order, axis=1), np.take_along_axis(idx, order, axis=1)
