"""Benchmark dataset loaders (port of benchmarks/datasets.py; numpy only).

Nothing is downloaded: the sweep uses synthetic stand-ins unless the
standard SIFT1M / GloVe-100 files are present. If they appear under
``hnsw_tpu_torch/tools/data/`` (or $HNSW_TPU_DATA), the loaders below
pick them up and the sweep's rows switch to the real datasets:

  sift/sift_base.fvecs, sift_query.fvecs, sift_groundtruth.ivecs
  glove-100/glove-100-angular.hdf5   (ann-benchmarks format)

fvecs/ivecs: little-endian rows of (int32 dim, dim * (f32|i32)).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

DATA_DIR = os.environ.get(
    "HNSW_TPU_DATA", os.path.join(os.path.dirname(__file__), "data"))


def read_fvecs(path: str, dtype=np.float32) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype)
    dim = int(raw[0])
    rows = raw.reshape(-1, dim + 1)[:, 1:]
    return rows.view(np.float32).astype(dtype) if dtype == np.float32 \
        else rows.astype(dtype)


def read_ivecs(path: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    dim = int(raw[0])
    return raw.reshape(-1, dim + 1)[:, 1:]


def load_sift1m() -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(base [1M,128], queries [10k,128], gt [10k,100]) or None."""
    d = os.path.join(DATA_DIR, "sift")
    paths = [os.path.join(d, f) for f in
             ("sift_base.fvecs", "sift_query.fvecs",
              "sift_groundtruth.ivecs")]
    if not all(os.path.exists(p) for p in paths):
        return None
    return (read_fvecs(paths[0]), read_fvecs(paths[1]),
            read_ivecs(paths[2]))


def load_glove100() -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(base, queries, gt) from the ann-benchmarks hdf5, or None."""
    p = os.path.join(DATA_DIR, "glove-100", "glove-100-angular.hdf5")
    if not os.path.exists(p):
        return None
    try:
        import h5py  # optional dependency
    except ImportError:
        return None
    with h5py.File(p, "r") as f:
        return (np.asarray(f["train"], np.float32),
                np.asarray(f["test"], np.float32),
                np.asarray(f["neighbors"], np.int64))


def synthetic_standin(n: int, dim: int, n_q: int, seed: int = 0,
                      kind: str = "random"):
    """The sweep's stand-in when real data is absent."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        n_c = max(1, n // 100)
        centers = rng.standard_normal((n_c, dim)).astype(np.float32) * 5
        asg = rng.integers(0, n_c, n)
        base = (centers[asg]
                + 0.3 * rng.standard_normal((n, dim)).astype(np.float32))
        qasg = rng.integers(0, n_c, n_q)
        queries = (centers[qasg]
                   + 0.3 * rng.standard_normal((n_q, dim))
                   .astype(np.float32))
    else:
        base = rng.standard_normal((n, dim)).astype(np.float32)
        queries = rng.standard_normal((n_q, dim)).astype(np.float32)
    return base, queries
