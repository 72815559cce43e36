"""Host-side exact f32 rerank of device-selected candidate slots.

The capacity modes (Graph.hbm_mode="quantized", ExactIndex
hbm_dtype="bf16"/"int8") keep only a reduced-precision table in HBM; the
device scan nominates candidates and this one batched host fetch
restores exact f32 distances and ordering (the GetVectorsBatch role,
reference parquet/vector_ops.go:321-432).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hnsw_tpu_torch.ops.distance import INF_DIST, np_gram_epilogue


def host_rerank(store, metric: str, queries: np.ndarray,
                cand: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact f32 rerank of per-query candidate slots against the
    host/disk store.  cand: [Q, R] slot ids (-1 = none).  Returns
    (dists [Q, k], slots [Q, k]) exact-ordered."""
    nq, R = cand.shape
    safe = np.clip(cand, 0, max(store.capacity - 1, 0))
    rows = store.get_batch(safe.reshape(-1)).reshape(nq, R, -1)
    qf = np.asarray(queries, np.float32)
    qv = np.einsum("qd,qrd->qr", qf, rows.astype(np.float32))
    c_sq = store.sq_norms[safe]
    q_sq = np.sum(qf * qf, axis=-1)
    d = np_gram_epilogue(qv, q_sq[:, None], c_sq, metric)
    d = np.where(cand >= 0, d, INF_DIST).astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    dk = np.take_along_axis(d, order, axis=1)
    ik = np.take_along_axis(cand, order, axis=1).astype(np.int64)
    if k > dk.shape[1]:
        pad = k - dk.shape[1]
        dk = np.pad(dk, ((0, 0), (0, pad)), constant_values=INF_DIST)
        ik = np.pad(ik, ((0, 0), (0, pad)), constant_values=-1)
    ik = np.where(dk >= INF_DIST, -1, ik)
    return dk, ik
