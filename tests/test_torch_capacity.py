"""The exact tier's capacity modes: hnsw_tpu_torch against hnsw_tpu on the CPU.

Same seeded numpy inputs through both packages:

* ``quantized_topk_candidates`` over int8 / bf16 / fp16 tables, one chunk
  and several: candidate id overlap >= 0.99 (the scan's products are
  exact in f32, its sums run in another order, so a near tie at the
  kk boundary may resolve differently) and matched scan distances within
  1e-5;
* ``ExactIndex._sync``: the reduced tables are bit-equal to JAX's;
* ``ExactIndex`` per ``hbm_dtype``: final ids overlap >= 0.99, distances
  within 1e-5 (both rerank the candidates in f32 with the same numpy
  code); "auto" resolves to the same rung as JAX on Gaussian data and
  on tight clusters of two widths;
* ``batch_search_stream`` yields exactly what per-batch search returns.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu.ops import topk as jtopk  # noqa: E402
from hnsw_tpu_torch.ops import distance as tdist  # noqa: E402
from hnsw_tpu_torch.ops import topk as ttopk  # noqa: E402

DTYPES = ["int8", "bf16", "fp16"]


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _clustered(n, d, noise, seed=3, n_c=40):
    """tests/test_fast_serving.py's tight-cluster recipe."""
    r = np.random.default_rng(seed)
    centers = r.standard_normal((n_c, d)).astype(np.float32) * 5
    return (centers[r.integers(0, n_c, n)]
            + noise * r.standard_normal((n, d)).astype(np.float32))


def _overlap(a, b):
    return sum(len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
               for x, y in zip(a, b)) / max(1, int((b >= 0).sum()))


def _matched_err(da, ia, db, ib):
    err = 0.0
    for ra, rb, xa, xb in zip(ia, ib, da, db):
        pos = {int(i): j for j, i in enumerate(rb) if i >= 0}
        for j, i in enumerate(ra):
            if i >= 0 and int(i) in pos:
                err = max(err, abs(float(xa[j]) - float(xb[pos[int(i)]])))
    return err


def _tables(v, dtype):
    """(jax table, jax scales, torch table, torch scales): ExactIndex's
    per-row int8 quantisation, or a bf16 / fp16 cast."""
    if dtype == "int8":
        amax = np.max(np.abs(v), axis=1)
        s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
        return (jnp.asarray(q), jnp.asarray(s), torch.from_numpy(q),
                torch.from_numpy(s))
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "fp16": (jnp.float16, torch.float16)}[dtype]
    return (jnp.asarray(v, jdt), None, torch.from_numpy(v).to(tdt), None)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("chunk", [65536, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_topk_candidates_match_jax(dtype, chunk, metric):
    v = _data(1, 3000)
    q = _data(2, 16)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    valid = np.ones(3000, bool)
    valid[100:160] = False
    jt, js, tt, ts = _tables(v, dtype)
    dj, ij = jtopk.quantized_topk_candidates(
        jnp.asarray(q), jt, js, jnp.asarray(sq), jnp.asarray(valid), kk=26,
        metric=metric, chunk=chunk)
    dt, it = ttopk.quantized_topk_candidates(
        torch.from_numpy(q), tt, ts, torch.from_numpy(sq),
        torch.from_numpy(valid), kk=26, metric=metric, chunk=chunk)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = dt.numpy(), it.numpy()
    assert it.shape == ij.shape == (16, 26)
    assert not np.isin(it, np.arange(100, 160)).any()
    assert np.all(np.diff(dt, axis=1) >= 0)
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5


def test_high_precision_is_f32():
    """HIGH multiplies f32 operands in f32, as HIGHEST does."""
    q, v = torch.from_numpy(_data(3, 5)), torch.from_numpy(_data(4, 40))
    a = tdist.pairwise_dist(q, v, metric="l2", precision=tdist.HIGH)
    b = tdist.pairwise_dist(q, v, metric="l2", precision=tdist.HIGHEST)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    x = _data(5, 7)
    np.testing.assert_array_equal(
        tdist.np_bf16_round(x), tdist.bf16_round(torch.from_numpy(x)).numpy())


def _pair(metric, dtype, v):
    j = hnsw_tpu.ExactIndex(metric=metric, hbm_dtype=dtype)
    t = hnsw_tpu_torch.ExactIndex(metric=metric, hbm_dtype=dtype,
                                  device="cpu")
    j.host_serve_max_batch = t.host_serve_max_batch = 0
    keys = list(range(len(v)))
    j.batch_add(keys, v)
    t.batch_add(keys, v)
    return j, t


@pytest.mark.parametrize("dtype", DTYPES + ["float32"])
def test_sync_tables_equal_jax(dtype):
    v = _data(6, 1500)
    j, t = _pair("cosine", dtype, v)
    jd, td = j._sync(), t._sync()
    tab = td[0]
    assert tab.dtype == {"int8": torch.int8, "bf16": torch.bfloat16,
                         "fp16": torch.float16,
                         "float32": torch.float32}[dtype]
    assert tab.shape == (2048, 32)
    if dtype == "bf16":
        np.testing.assert_array_equal(tab.view(torch.int16).numpy(),
                                      np.asarray(jd[0]).view(np.int16))
    else:
        np.testing.assert_array_equal(tab.numpy(), np.asarray(jd[0]))
    for a, b in zip(td[1:], jd[1:]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_search_with_deletes_matches_jax(dtype, metric):
    v = _data(7, 2000)
    j, t = _pair(metric, dtype, v)
    for idx in (j, t):
        idx.batch_delete(list(range(0, 2000, 7)))
    q = np.concatenate([v[:5], _data(8, 30)])
    dj, ij = j.batch_search_slots(q, 10)
    dt, it = t.batch_search_slots(q, 10)
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5
    assert not np.isin(it, np.arange(0, 2000, 7)).any()


@pytest.mark.parametrize("data", ["gauss", "clustered-0.3", "clustered-0.05"])
def test_auto_resolves_like_jax(data):
    """Gaussian rows take int8; the tight-cluster recipe falls to fp16,
    and five times tighter clusters to float32 — in both packages."""
    v = {"gauss": lambda: _data(9, 3000),
         "clustered-0.3": lambda: _clustered(4000, 64, 0.3),
         "clustered-0.05": lambda: _clustered(4000, 64, 0.05)}[data]()
    want = {"gauss": "int8", "clustered-0.3": "fp16",
            "clustered-0.05": "float32"}[data]
    j, t = _pair("cosine", "auto", v)
    n = len(v)
    assert t._resolve_hbm_dtype(n) == j._resolve_hbm_dtype(n) == want
    # cached until a quarter of the index changed
    t.batch_add([n], v[:1])
    assert t._hbm_fit_cache == (want, n) and t._muts_since_fit == 1
    q = v[:20] + 0.01
    dj, ij = j.batch_search_slots(q, 10)
    dt, it = t.batch_search_slots(q, 10)
    assert t._resolved_hbm == j._resolved_hbm == want
    assert _overlap(it, ij) >= 0.99
    assert _matched_err(dt, it, dj, ij) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES + ["float32"])
def test_batch_search_stream_equals_per_batch(dtype):
    v = _data(10, 2500)
    j, t = _pair("l2", dtype, v)
    batches = [_data(11 + b, nq) for b, nq in enumerate((17, 32, 5))]
    streamed = list(t.batch_search_stream(iter(batches), 10))
    assert len(streamed) == 3
    for q, (ds, is_) in zip(batches, streamed):
        d, i = t.batch_search_slots(q, 10)
        np.testing.assert_array_equal(is_, i)
        np.testing.assert_array_equal(ds, d)
    for q, (ds, is_), (dj, ij) in zip(
            batches, streamed, j.batch_search_stream(iter(batches), 10)):
        assert _overlap(is_, ij) >= 0.99
    with pytest.raises(ValueError):
        list(t.batch_search_stream([batches[0]], 0))


def test_hbm_dtype_setter_rebuilds_table():
    v = _data(12, 600)
    t = hnsw_tpu_torch.ExactIndex(metric="l2", hbm_dtype="int8",
                                  device="cpu")
    t.host_serve_max_batch = 0
    t.batch_add(list(range(600)), v)
    _, i8 = t.batch_search_slots(v[:9], 3)
    assert t._dev[0].dtype == torch.int8
    t.hbm_dtype = "half"
    assert t.hbm_dtype == "fp16" and t._dev is None
    _, i16 = t.batch_search_slots(v[:9], 3)
    assert t._dev[0].dtype == torch.float16 and t._dev[3] is None
    np.testing.assert_array_equal(i8[:, 0], np.arange(9))
    np.testing.assert_array_equal(i16, i8)
    with pytest.raises(ValueError):
        t.hbm_dtype = "int4"
