"""tools/datasets of the port against benchmarks/datasets.py: the fvecs /
ivecs readers and the SIFT1M loader on temporary files, and
``synthetic_standin`` on seeds, give equal arrays (exact: both are numpy
on the same bytes and generators)."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from benchmarks import datasets as jds  # noqa: E402
from hnsw_tpu_torch.tools import datasets as tds  # noqa: E402


def _write_vecs(path, rows, dtype):
    rows = np.asarray(rows, dtype)
    dims = np.full((len(rows), 1), rows.shape[1], np.int32)
    np.concatenate([dims, rows.view(np.int32)], axis=1).tofile(path)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_read_fvecs_equals_jax(tmp_path, dtype):
    rows = np.random.default_rng(0).standard_normal((37, 12))
    path = str(tmp_path / "x.fvecs")
    _write_vecs(path, rows, np.float32)
    got, want = tds.read_fvecs(path, dtype), jds.read_fvecs(path, dtype)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = str(tmp_path / "empty.fvecs")
    open(empty, "wb").close()
    assert tds.read_fvecs(empty).shape == jds.read_fvecs(empty).shape


def test_read_ivecs_equals_jax(tmp_path):
    rows = np.random.default_rng(1).integers(0, 10**6, (21, 100))
    path = str(tmp_path / "gt.ivecs")
    _write_vecs(path, rows, np.int32)
    got, want = tds.read_ivecs(path), jds.read_ivecs(path)
    assert np.array_equal(got, want) and np.array_equal(got, rows)


def test_sift_and_glove_loaders_equal_jax(tmp_path, monkeypatch):
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "DATA_DIR", str(tmp_path))
    assert tds.load_sift1m() is None and jds.load_sift1m() is None
    assert tds.load_glove100() is None and jds.load_glove100() is None
    rng = np.random.default_rng(2)
    os.makedirs(tmp_path / "sift")
    _write_vecs(str(tmp_path / "sift" / "sift_base.fvecs"),
                rng.standard_normal((50, 8)), np.float32)
    _write_vecs(str(tmp_path / "sift" / "sift_query.fvecs"),
                rng.standard_normal((5, 8)), np.float32)
    _write_vecs(str(tmp_path / "sift" / "sift_groundtruth.ivecs"),
                rng.integers(0, 50, (5, 10)), np.int32)
    got, want = tds.load_sift1m(), jds.load_sift1m()
    assert [a.shape for a in got] == [(50, 8), (5, 8), (5, 10)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_standin_equals_jax(kind, seed):
    got = tds.synthetic_standin(1000, 24, 64, seed=seed, kind=kind)
    want = jds.synthetic_standin(1000, 24, 64, seed=seed, kind=kind)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
