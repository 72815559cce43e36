"""Random-hyperplane LSH ops (port of hnsw_tpu/ops/hashing.py).

The reference computes per-vector hash bits in a scalar loop
(hybrid/lsh.go:95-116). Here hashing T tables x B bits for N vectors is
ONE [N, D] x [D, T*B] matmul plus a sign/bit-pack epilogue.

Deliberate fix (SURVEY.md §7.4): the reference "normalizes" hyperplanes
by dividing by the SQUARED norm (lsh.go:85); we normalize correctly
(irrelevant for sign bits, but the planes are reusable elsewhere).
"""

from __future__ import annotations

import numpy as np
import torch

# importing ops.distance pins TF32 off for every f32 matmul
from hnsw_tpu_torch.ops import distance as _distance  # noqa: F401


def make_hyperplanes(num_tables: int, num_bits: int, dim: int,
                     seed: int = 42) -> np.ndarray:
    """[T, B, D] unit-norm random hyperplanes (reference seeds 42,
    lsh.go:64)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((num_tables, num_bits, dim)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True) + 1e-30
    return h


def np_hash_codes(vectors: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of hash_codes — the latency tier hashes small
    query batches without a device round-trip. Bit-for-bit the same
    packing; a projection landing EXACTLY on 0.0 could in principle
    sign differently between BLAS and the device's summation order,
    which for LSH means a different (equally valid) bucket probe."""
    T, B, D = planes.shape
    proj = np.asarray(vectors, np.float32) @ planes.reshape(T * B, D).T
    bits = (proj > 0).reshape(-1, T, B).astype(np.int64)
    return np.sum(bits << np.arange(B, dtype=np.int64)[None, None, :],
                  axis=-1)


def hash_codes(vectors: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Pack sign bits into per-table int64 codes, on the tensors' device.

    vectors: [N, D]; planes: [T, B, D] -> codes int64 [N, T].
    bit b of table t = sign(<v, planes[t, b]>) (lsh.go:95-116, batched).

    The product is one full-f32 matmul (TF32 stays off, ops/distance): a
    TF32 or bf16 product flips the sign of projections near zero, and
    with them the bucket.
    """
    T, B, D = planes.shape
    if B > 30:
        raise ValueError("num_bits must be <= 30 (int32 packing)")
    proj = vectors.to(torch.float32) @ planes.reshape(T * B, D).T  # [N, T*B]
    bits = (proj > 0).reshape(-1, T, B).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=proj.device) \
        << torch.arange(B, dtype=torch.int64, device=proj.device)
    return torch.sum(bits * weights, dim=-1)                        # [N, T]
