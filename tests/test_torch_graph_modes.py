"""Graph's serving and capacity modes: hnsw_tpu_torch.Graph against hnsw_tpu.

Both packages build with the shared native builder from the same seed, so
their host arrays are equal; then both serve in the same mode. On the
device path (JAX on its CPU backend, the port on the CPU) ids must
overlap >= 0.99 (hop distances are f32 sums in another order, which can
steer a near tie) with matched distances within 1e-5; the modes that
rerank on the host rerank with the same numpy code. The native tier runs
the same C++ engine in both, so its results are equal. Compact uppers,
ef calibration, batch delete, lookup and negatives are in
tests/test_torch_graph_api.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402

N, D = 2000, 32


def _data(seed, n, d=D):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _clustered(n, d, seed=3, n_c=20, noise=0.1):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((n_c, d)).astype(np.float32) * 5
    return (centers[r.integers(0, n_c, n)]
            + noise * r.standard_normal((n, d)).astype(np.float32))


def _build(metric="cosine", v=None, store_dtype="float32", seed=0):
    v = _data(1, N) if v is None else v
    keys = list(range(len(v)))
    cfg = dict(m=8, ml=0.06, ef_construction=64, metric=metric, seed=seed,
               store_dtype=store_dtype)
    j = hnsw_tpu.Graph(config=hnsw_tpu.GraphConfig(**cfg))
    t = hnsw_tpu_torch.Graph(config=hnsw_tpu_torch.GraphConfig(**cfg),
                             device="cpu")
    j.build(keys, v, method="host")
    t.build(keys, v, method="host")
    j.merge_strategy = t.merge_strategy = "sort"   # faster JAX compile
    return j, t, v


def _host_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.host.arrays(),
                                                    b.host.arrays()))


def _serve_both(j, t, q, k=10, ef=48):
    j.native_serve_max_batch = t.native_serve_max_batch = 0
    dj, ij = j.batch_search_slots(q, k, ef=ef)
    dt, it = t.batch_search_slots(q, k, ef=ef)
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ij, it))
    assert hits / max(1, int((ij >= 0).sum())) >= 0.99
    same = ij == it
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-5, rtol=0)
    return dt, it


@pytest.mark.parametrize("mode", ["float16", "quantized"])
def test_hbm_modes_match_jax(mode):
    j, t, v = _build()
    j.hbm_mode = t.hbm_mode = mode
    assert t.hbm_mode == mode
    dev = t.device_graph()
    if mode == "float16":
        assert dev.vectors.dtype == torch.float16 and dev.qvec is None
    else:
        assert tuple(dev.vectors.shape) == (1, D)
        assert dev.qvec.dtype == torch.int8 and dev.cap == 2048
    q = np.concatenate([v[:16], _data(2, 48)])
    dt, it = _serve_both(j, t, q)
    # exact f32 host rerank: found selves come back at ~zero distance
    found = it[:16, 0] == np.arange(16)
    assert found.mean() >= 0.9 and np.all(dt[:16][found, 0] < 1e-5)


@pytest.mark.parametrize("store_dtype", ["float16", "bfloat16"])
def test_reduced_store_dtypes_match_jax(store_dtype):
    j, t, _ = _build(metric="l2", store_dtype=store_dtype)
    assert t.device_graph().vectors.dtype == {
        "float16": torch.float16, "bfloat16": torch.bfloat16}[store_dtype]
    _serve_both(j, t, _data(3, 48))


def test_pivot_entry_matches_jax_on_device_and_native():
    j, t, v = _build()
    j.entry_mode = t.entry_mode = "pivots"
    with pytest.raises(ValueError):
        t.entry_mode = "upper"
    _serve_both(j, t, _data(4, 48))
    assert len(t.last_search_hops) == 1          # layer 0 only
    np.testing.assert_array_equal(t._pivot_arrays()[0].numpy(),
                                  np.asarray(j._pivot_arrays()[0]))
    # the native tier seeds from the same host pivots
    np.testing.assert_array_equal(t._pivot_slots_host(),
                                  j._pivot_slots_host())
    j.native_serve_max_batch = t.native_serve_max_batch = 32
    q = _data(5, 8)
    dj, ij = j.batch_search_slots(q, 10, ef=48)
    dt, it = t.batch_search_slots(q, 10, ef=48)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    # a rebuilt device graph drops the cached pivots
    t.delete(int(t._pivot_arrays()[0][0]))
    t.device_graph()
    assert t._pivot_cache is None


def test_block_layout_matches_jax():
    j, t, v = _build()
    for g in (j, t):
        g.block_layout = True
        g.entry_mode = "pivots"
        g.fast_math = True
    dev = t.device_graph()
    assert str(dev.nbr_blocks.dtype) == "torch.int8"
    assert tuple(dev.nbr_blocks.shape) == (2048, 16, D)
    assert str(j.device_graph().nbr_blocks.dtype) == "int8"
    j.fast_math = False      # the JAX CPU backend keeps f32 at DEFAULT
    t.fast_math = False
    _serve_both(j, t, _data(6, 48))
    t.block_m = 6
    assert t.device_graph().nbr_blocks.shape[1] == 6
    with pytest.raises(ValueError):
        t.block_dtype = "int4"


def test_auto_block_dtype_resolves_like_jax():
    """Tight clusters drown in int8 noise: "auto" falls to fp16 blocks in
    both packages, and the fit is cached until the data changes."""
    j, t, _ = _build(v=_clustered(1500, D))
    for g in (j, t):
        g.block_layout = True
    assert t._resolve_block_dtype(1500) == j._resolve_block_dtype(1500) \
        == "float16"
    assert t.device_graph().nbr_blocks.dtype == torch.float16
    t.build(list(range(1500)), _data(7, 1500))
    assert t._block_fit_cache is None
    assert t.device_graph().nbr_blocks.dtype == torch.int8
    t.block_dtype = "float16"
    assert t.device_graph().nbr_blocks.dtype == torch.float16
