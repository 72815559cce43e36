"""Batched distance ops on torch tensors (port of hnsw_tpu/ops/distance.py).

Every distance is one matmul (``queries @ vectors.T``) plus an elementwise
epilogue over the Gram block:

    cosine(a,b)      = 1 - <a,b> / (|a||b|)          (distance.go:16)
    l2(a,b)          = sqrt(|a|^2 + |b|^2 - 2<a,b>)  (distance.go:21)
    sqeuclidean(a,b) = |a|^2 + |b|^2 - 2<a,b>
    dot(a,b)         = -<a,b>            (inner-product search ordering)

Precision map (JAX ``lax.Precision`` -> this module):

    HIGHEST -> "highest": f32 inputs, f32 products and sums. TF32 stays off
               (``torch.backends.cuda.matmul.allow_tf32 = False``, set
               below), so a CUDA GEMM keeps full f32.
    HIGH    -> "high": the same f32 GEMM. On the TPU it is three bf16
               passes (~f32-accurate); the fp16 capacity tables use it, so
               an fp16 store is upcast to f32 and multiplied in f32, never
               in fp16.
    DEFAULT -> "default": both operands rounded to bf16, products and sums
               in f32 -- bf16 x bf16 with f32 output. (A bf16 GEMM in torch
               would return bf16 and round the Gram before the epilogue.)

Every bf16 rounding goes through ``bf16_round`` (torch's round to nearest
even, the rounding ``ml_dtypes`` and XLA use). int8 tables convert to
bf16 exactly (|q| <= 127 fits bf16's 8 significand bits), so their
dequantisation is a plain upcast and the per-row scale multiplies the
Gram in the epilogue.

The numpy twins (``np_gram_epilogue``, ``np_pairwise_dist``,
``point_dist``) are the JAX package's, verbatim. The registry mirrors the
reference's ``RegisterDistanceFunc`` (distance.go:25-46); a registered
``pairwise_fn`` takes and returns torch tensors.

Numerical note: the Gram-based l2 epilogue (|a|^2+|b|^2-2ab) cancels
catastrophically when coordinates are huge relative to neighbor gaps
(|x| ~ 1e4 in f32) -- the standard trade of this formulation.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from hnsw_tpu_torch.config import canonical_metric

# HIGHEST precision means full-f32 GEMMs on the card (PyTorch's default,
# pinned here so that a caller's TF32 opt-in cannot change the results).
torch.backends.cuda.matmul.allow_tf32 = False

# Large-but-finite sentinel: masked / invalid entries get this distance.
INF_DIST = np.float32(3.0e38)

_EPS = 1e-30

HIGHEST = "highest"
HIGH = "high"
DEFAULT = "default"


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def np_bf16_round(x: np.ndarray) -> np.ndarray:
    """``bf16_round`` for numpy arrays (f32 in, f32 out)."""
    return bf16_round(torch.from_numpy(
        np.ascontiguousarray(x, np.float32))).numpy()


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in (HIGHEST, HIGH):
        return x
    if precision == DEFAULT:
        return bf16_round(x)
    raise ValueError(f"unknown precision {precision!r}")


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared norms, f32."""
    x = x.to(torch.float32)
    return torch.sum(x * x, dim=-1)


def _epilogue(metric: str, qv: torch.Tensor, q_sq: torch.Tensor,
              v_sq: torch.Tensor) -> torch.Tensor:
    """Turn a Gram block ``qv = Q @ V.T`` into distances.

    q_sq: [..., Q] squared norms of queries (broadcast over trailing axis)
    v_sq: [..., N] squared norms of the scored vectors.
    """
    if metric == "cosine":
        denom = torch.rsqrt(q_sq[..., :, None] * v_sq[..., None, :] + _EPS)
        return 1.0 - qv * denom
    if metric == "sqeuclidean":
        d = q_sq[..., :, None] + v_sq[..., None, :] - 2.0 * qv
        return torch.clamp_min(d, 0.0)
    if metric == "l2":
        d = q_sq[..., :, None] + v_sq[..., None, :] - 2.0 * qv
        return torch.sqrt(torch.clamp_min(d, 0.0))
    if metric == "dot":
        return -qv
    raise ValueError(f"unknown metric {metric}")


def pairwise_dist(queries: torch.Tensor, vectors: torch.Tensor,
                  v_sq: Optional[torch.Tensor] = None,
                  q_sq: Optional[torch.Tensor] = None,
                  metric: str = "cosine",
                  precision: str = HIGHEST) -> torch.Tensor:
    """Dense [Q, N] distance block via one matmul.

    ``precision`` defaults to HIGHEST (f32-exact) for ground truth; graph
    traversal may pass DEFAULT.
    """
    metric = canonical_metric(metric)
    qf = queries.to(torch.float32)
    vf = vectors.to(torch.float32)
    spec = _registry.get(metric)
    if spec is not None:
        return _custom_pairwise(metric, spec)(qf, vf)
    if q_sq is None:
        q_sq = sq_norms(qf)
    if v_sq is None:
        v_sq = sq_norms(vf)
    qv = _operand(qf, precision) @ _operand(vf, precision).transpose(-1, -2)
    return _epilogue(metric, qv, q_sq, v_sq)


def gathered_dist(queries: torch.Tensor, cand_vecs: torch.Tensor,
                  cand_sq: torch.Tensor, q_sq: torch.Tensor,
                  metric: str = "cosine",
                  precision: str = DEFAULT) -> torch.Tensor:
    """Distances from each query to ITS OWN candidate set.

    queries:   [B, D]
    cand_vecs: [B, C, D]   (gathered per-query neighbor vectors)
    cand_sq:   [B, C]
    q_sq:      [B]
    returns    [B, C]
    """
    metric = canonical_metric(metric)
    qf = queries.to(torch.float32)
    cf = cand_vecs.to(torch.float32)
    spec = _registry.get(metric)
    if spec is not None:
        pw = _custom_pairwise(metric, spec)
        return torch.stack([pw(qq[None, :], cc)[0] for qq, cc in zip(qf, cf)])
    qv = torch.einsum("bd,bcd->bc", _operand(qf, precision),
                      _operand(cf, precision))
    return gathered_epilogue(metric, qv, q_sq, cand_sq)


def gathered_epilogue(metric: str, qv: torch.Tensor, q_sq: torch.Tensor,
                      cand_sq: torch.Tensor) -> torch.Tensor:
    """Distances from a per-query candidate Gram block qv [B, C], with
    q_sq [B] and cand_sq [B, C] (the epilogue of ``gathered_dist``; the
    int8 and block hops compute their own qv)."""
    if metric == "cosine":
        denom = torch.rsqrt(q_sq[:, None] * cand_sq + _EPS)
        return 1.0 - qv * denom
    if metric == "sqeuclidean":
        return torch.clamp_min(q_sq[:, None] + cand_sq - 2.0 * qv, 0.0)
    if metric == "l2":
        return torch.sqrt(torch.clamp_min(q_sq[:, None] + cand_sq - 2.0 * qv,
                                          0.0))
    if metric == "dot":
        return -qv
    raise ValueError(f"unknown metric {metric}")


def point_dist(a, b, metric: str = "cosine") -> float:
    """Scalar distance between two vectors (host convenience; mirrors the
    reference's DistanceFunc call signature, distance.go:12)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    metric = canonical_metric(metric)
    spec = _registry.get(metric)
    if spec is not None:
        return float(spec["point"](a, b))
    ab = float(np.dot(a, b))
    if metric == "cosine":
        na = float(np.dot(a, a))
        nb = float(np.dot(b, b))
        return 1.0 - ab / np.sqrt(na * nb + _EPS)
    if metric == "sqeuclidean":
        return max(float(np.dot(a - b, a - b)), 0.0)
    if metric == "l2":
        return float(np.sqrt(max(np.dot(a - b, a - b), 0.0)))
    if metric == "dot":
        return -ab
    raise ValueError(metric)


def np_gram_epilogue(qv: np.ndarray, q_sq, c_sq,
                     metric: str) -> np.ndarray:
    """Distances from a precomputed Gram block — the host twin of the
    device epilogues above, for callers that already hold qv and the
    squared norms (candidate reranks, chunked oracle scans, bucket
    scans).  ``q_sq``/``c_sq`` must broadcast against ``qv``.  One
    epsilon convention for every site (the per-site copies this
    replaces had drifted on where 1e-30 was applied).  ``metric`` must
    be a canonical builtin name."""
    if metric == "dot":
        return -qv
    if metric == "cosine":
        return 1.0 - qv / np.sqrt(q_sq * c_sq + _EPS)
    d = np.maximum(q_sq + c_sq - 2.0 * qv, 0.0)
    if metric == "l2":
        d = np.sqrt(d)
    return d


def np_pairwise_dist(queries: np.ndarray, vectors: np.ndarray,
                     metric: str = "cosine") -> np.ndarray:
    """NumPy [Q, N] distances — host-side oracle / builder helper."""
    metric = canonical_metric(metric)
    q = np.asarray(queries, np.float32)
    v = np.asarray(vectors, np.float32)
    spec = _registry.get(metric)
    if spec is not None:
        if spec["pairwise"] is not None:
            return np.asarray(spec["pairwise"](
                torch.from_numpy(q), torch.from_numpy(v)), np.float32)
        return np.array([[spec["point"](qq, vv) for vv in v] for qq in q],
                        np.float32)
    qv = q @ v.T
    if metric == "dot":
        return -qv
    q_sq = np.sum(q * q, axis=-1)
    v_sq = np.sum(v * v, axis=-1)
    if metric == "cosine":
        denom = np.sqrt(q_sq[:, None] * v_sq[None, :] + _EPS)
        return 1.0 - qv / denom
    d = np.maximum(q_sq[:, None] + v_sq[None, :] - 2.0 * qv, 0.0)
    if metric == "sqeuclidean":
        return d
    return np.sqrt(d)


# ---------------------------------------------------------------------------
# Distance registry — mirrors reference RegisterDistanceFunc
# (distance.go:25-46): names are what checkpoints store, so custom metrics
# must be registered before Import.
# ---------------------------------------------------------------------------

#: name -> {"point": host fn, "pairwise": torch fn or None}
_registry: Dict[str, dict] = {}


def _custom_pairwise(name: str, spec: dict) -> Callable:
    """The torch pairwise fn of a registered metric, or a clear error."""
    pw = spec.get("pairwise")
    if pw is None:
        raise ValueError(
            f"custom metric {name!r} was registered without a torch "
            f"pairwise_fn; device search requires one — "
            f"register_distance({name!r}, point_fn, pairwise_fn=...)")
    return pw


def register_distance(name: str,
                      point_fn: Callable[[np.ndarray, np.ndarray], float],
                      pairwise_fn: Optional[Callable] = None) -> None:
    """Register a custom distance under ``name`` (reference:
    RegisterDistanceFunc, distance.go:44). The name becomes a valid
    ``metric=`` everywhere a builtin is.

    ``point_fn(a, b) -> float`` is required (host oracle).
    ``pairwise_fn(Q [Q,D], V [N,D]) -> [Q,N]`` takes and returns torch
    tensors and is required for any device path. Larger = farther;
    returned distances must stay finite and below ~3e38 (INF_DIST is the
    masked sentinel).
    """
    from hnsw_tpu_torch.config import METRICS
    if name.lower() in METRICS or name.lower() == "euclidean":
        raise ValueError(f"cannot override builtin metric {name!r}")
    _registry[name] = {"point": point_fn, "pairwise": pairwise_fn}


def resolve_metric(name: str) -> str:
    """Validate a metric name is either builtin or registered."""
    try:
        return canonical_metric(name)
    except ValueError:
        if name in _registry:
            return name
        raise


def registered(name: str) -> Optional[dict]:
    return _registry.get(name)
