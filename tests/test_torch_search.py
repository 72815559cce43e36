"""hnsw_tpu_torch.core.search against hnsw_tpu.core.search on the CPU.

One graph is built by hnsw_tpu (native host builder), laid out by its
``Graph.device_graph()``, and moved into the port with
``convert.device_graph_from_numpy``; both ``search_graph``s then serve
the same queries. Id overlap must be >= 0.99 and matched distances within
1e-5: the hop distances are f32 sums taken in another order, so a near
tie at the pool's edge may resolve differently and steer a hop.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.core import search as jsearch  # noqa: E402
from hnsw_tpu.core import state as jstate  # noqa: E402
from hnsw_tpu_torch.convert import device_graph_from_numpy  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core import state as tstate  # noqa: E402


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    """(jax DeviceGraph, port DeviceGraph, queries) per metric."""
    out = {}
    for metric in ("cosine", "l2"):
        g = hnsw_tpu.Graph(m=8, ef_construction=64, metric=metric, seed=3)
        v = _data(1, 2500)
        g.build(list(range(len(v))), v, method="host")
        g.batch_delete(list(range(0, 2500, 50)))      # tombstones
        dev = g.device_graph()
        fields = {k: np.asarray(x) for k, x in dev._asdict().items()
                  if x is not None}
        out[metric] = (dev, device_graph_from_numpy(fields, "cpu"),
                       _data(2, 64))
    return out


def _overlap_and_err(dj, ij, dt, it):
    hits, err = 0, 0.0
    for rdj, rij, rdt, rit in zip(dj, ij, dt, it):
        pos = {int(x): p for p, x in enumerate(rit) if x >= 0}
        for p, x in enumerate(rij):
            if x >= 0 and int(x) in pos:
                hits += 1
                err = max(err, abs(float(rdt[pos[int(x)]]) - float(rdj[p])))
    return hits / max(1, int((ij >= 0).sum())), err


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_search_graph_matches_jax(graphs, metric, merge, expand):
    jg, tg, q = graphs[metric]
    kw = dict(k=10, ef=48, metric=metric, max_hops=64, expand=expand,
              merge=merge)
    dj, ij = jsearch.search_graph(jg, jnp.asarray(q), **kw)
    stats = {}
    dt, it = tsearch.search_graph(tg, torch.from_numpy(q), stats=stats,
                                  **kw)
    ov, err = _overlap_and_err(np.asarray(dj), np.asarray(ij), dt.numpy(),
                               it.numpy())
    assert ov >= 0.99 and err <= 1e-5, (ov, err)
    assert len(stats["hops"]) == tg.num_layers
    assert 0 < stats["hops"][-1] <= 64


def test_fast_math_search_matches_jax(graphs):
    """fast_math: bf16 hop scoring (the JAX CPU backend keeps f32 at
    DEFAULT, so only the traversal may differ) + f32 rerank of the head."""
    jg, tg, q = graphs["cosine"]
    kw = dict(k=10, ef=64, metric="cosine", expand=4, merge="bitonic",
              fast_math=True)
    dj, ij = jsearch.search_graph(jg, jnp.asarray(q), **kw)
    dt, it = tsearch.search_graph(tg, torch.from_numpy(q), **kw)
    ov, err = _overlap_and_err(np.asarray(dj), np.asarray(ij), dt.numpy(),
                               it.numpy())
    assert ov >= 0.95 and err <= 1e-5, (ov, err)


def test_pivot_seeded_search_matches_jax(graphs):
    jg, tg, q = graphs["l2"]
    pids = np.arange(5, 2500, 37, dtype=np.int32)
    pv = np.asarray(jg.vectors)[pids]
    psq = np.sum(pv * pv, axis=1)
    sj = jsearch.pivot_seeds(jnp.asarray(q), jnp.asarray(pv),
                             jnp.asarray(psq), jnp.asarray(pids), s=6,
                             metric="l2")
    st = tsearch.pivot_seeds(torch.from_numpy(q), torch.from_numpy(pv),
                             torch.from_numpy(psq), torch.from_numpy(pids),
                             s=6, metric="l2")
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    kw = dict(k=10, ef=32, metric="l2", expand=2, merge="bitonic")
    dj, ij = jsearch.search_graph(jg, jnp.asarray(q), seed_ids=sj, **kw)
    dt, it = tsearch.search_graph(tg, torch.from_numpy(q), seed_ids=st,
                                  **kw)
    ov, err = _overlap_and_err(np.asarray(dj), np.asarray(ij), dt.numpy(),
                               it.numpy())
    assert ov >= 0.99 and err <= 1e-5, (ov, err)


def test_bitonic_merge_and_dedup_match_jax():
    r = np.random.default_rng(4)
    pool_d = np.sort(r.random((6, 12)).astype(np.float32), axis=1)
    pool_d[:, 9:] = np.float32(3e38)
    pool_i = np.where(pool_d < 3e38, r.integers(0, 1000, (6, 12)), -1
                      ).astype(np.int32)
    cand_d = r.random((6, 9)).astype(np.float32)
    cand_i = r.integers(0, 1000, (6, 9)).astype(np.int32)
    jd, ji = jsearch._bitonic_merge(*map(jnp.asarray, (pool_d, pool_i,
                                                        cand_d, cand_i)), 12)
    td, ti = tsearch._bitonic_merge(*map(torch.from_numpy,
                                         (pool_d, pool_i, cand_d, cand_i)),
                                    12)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    dup_i = np.array([[1, 1, 2, 2, 2, -1, -1]], np.int32)
    dup_d = np.float32([[0.1, 0.1, 0.2, 0.2, 0.2, 3e38, 3e38]])
    exp = np.zeros_like(dup_i, bool)
    want = jsearch._dedup_adjacent(jnp.asarray(dup_d), jnp.asarray(dup_i),
                                   jnp.asarray(exp))
    got = tsearch._dedup_adjacent(torch.from_numpy(dup_d),
                                  torch.from_numpy(dup_i),
                                  torch.from_numpy(exp))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_from_host_matches_jax():
    r = np.random.default_rng(5)
    n, L, m = 37, 3, 8
    vec = _data(6, n, 16)
    sq = np.sum(vec * vec, axis=1)
    nb = r.integers(-1, n, (L, n, m)).astype(np.int32)
    lv = r.integers(-1, L, n).astype(np.int32)
    alive = r.random(n) > 0.2
    jg = jstate.from_host(vec, sq, nb, lv, alive, 4)
    tg = tstate.from_host(vec, sq, nb, lv, alive, 4, device="cpu")
    for name, want in jg._asdict().items():
        got = getattr(tg, name, None)
        if want is None:
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    assert tg.cap == jg.cap == 64 and tg.num_layers == jg.num_layers
    with pytest.raises(ValueError, match="2\\^30"):
        tstate.from_host(vec, sq, nb, lv, alive, 4, cap_pad=1 << 30,
                         device="cpu")
    # the int8 traversal store, once not ported, is JAX's bit for bit
    jq = jstate.from_host(vec, sq, nb, lv, alive, 4, quantize=True)
    tq = tstate.from_host(vec, sq, nb, lv, alive, 4, quantize=True,
                          device="cpu")
    np.testing.assert_array_equal(tq.qvec.numpy(), np.asarray(jq.qvec))
    np.testing.assert_array_equal(tq.qscale.numpy(), np.asarray(jq.qscale))
    with pytest.raises(ValueError, match="hbm_vectors"):
        tstate.from_host(vec, sq, nb, lv, alive, 4, hbm_vectors=False,
                         device="cpu")


def test_device_graph_from_numpy_rejects_other_layouts(graphs):
    """Every layout is carried now (tests/test_torch_layouts.py holds each
    one); what is still refused is a field DeviceGraph does not have."""
    jg, tg, q = graphs["cosine"]
    fields = {k: np.asarray(x) for k, x in jg._asdict().items()
              if x is not None}
    fields["qvec"] = np.zeros((jg.cap, jg.dim), np.int8)
    fields["qscale"] = np.ones((jg.cap,), np.float32)
    dev = device_graph_from_numpy(fields, "cpu")
    assert dev.qvec.dtype == torch.int8 and dev.cap == tg.cap
    fields["pivots"] = np.zeros((4,), np.int32)
    with pytest.raises(ValueError, match="pivots"):
        device_graph_from_numpy(fields, "cpu")
