"""The serving slice end to end: hnsw_tpu_torch.Graph against hnsw_tpu.Graph.

Both packages build with the shared native builder from the same seed,
so their host arrays must be equal. Served on the device path
(native_serve_max_batch = 0: JAX on its CPU backend, the port on the
CPU), results must overlap >= 0.99 (hop distances are f32 sums in
another order, which can steer a near tie) with matched distances within
1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.convert import graph_from_host_arrays  # noqa: E402

N = 3000


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _build(metric, seed=0):
    v = _data(1, N)
    keys = [f"doc-{i}" for i in range(N)]
    j = hnsw_tpu.Graph(m=8, ef_construction=64, metric=metric, seed=seed)
    t = hnsw_tpu_torch.Graph(m=8, ef_construction=64, metric=metric,
                             seed=seed, device="cpu")
    j.build(keys, v, method="host")
    t.build(keys, v, method="host")
    return j, t, v


def _host_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.host.arrays(),
                                                    b.host.arrays()))


def _overlap(ij, it):
    return sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ij, it)) / max(1, int((ij >= 0).sum()))


def _serve_both(j, t, q, k=10, ef=64):
    j.native_serve_max_batch = t.native_serve_max_batch = 0
    dj, ij = j.batch_search_slots(q, k, ef=ef)
    dt, it = t.batch_search_slots(q, k, ef=ef)
    assert _overlap(ij, it) >= 0.99
    same = ij == it
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-5, rtol=0)
    return it


@pytest.fixture(scope="module", params=["cosine", "l2"])
def pair(request):
    return _build(request.param)


def test_build_gives_equal_host_arrays(pair):
    j, t, _ = pair
    assert _host_equal(j, t)
    assert t.num_layers == j.num_layers and len(t) == len(j) == N


def test_batch_search_matches_jax(pair):
    j, t, v = pair
    q = _data(2, 100)
    it = _serve_both(j, t, q)
    kj, _ = j.batch_search(q[:5], 10)
    kt, _ = t.batch_search(q[:5], 10)
    assert sum(len(set(a) & set(b)) for a, b in zip(kj, kt)) >= 0.99 * 50
    assert it.shape == (100, 10) and t.last_search_hops
    # self-retrieval through the device path
    _, self_ids = t.batch_search_slots(v[:64], 1, ef=128)
    assert np.mean(self_ids[:, 0] == np.arange(64)) >= 0.99


def test_native_tier_matches_jax(pair):
    """Small batches go to the shared native engine in both packages."""
    j, t, _ = pair
    j.native_serve_max_batch = t.native_serve_max_batch = 32
    q = _data(3, 8)
    dj, ij = j.batch_search_slots(q, 10, ef=48)
    dt, it = t.batch_search_slots(q, 10, ef=48)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert t.search(_data(1, N)[7], 1)[0][0] == "doc-7"


def test_graph_from_host_arrays_round_trips(pair):
    j, t, _ = pair
    n = j.slots.capacity_used
    g = graph_from_host_arrays(j.cfg, j.slots.slot_to_key,
                               j.store.vectors[:n], j.store.alive[:n],
                               *j.host.arrays(), device="cpu")
    assert _host_equal(g, j) and g.keys() == j.keys()
    np.testing.assert_array_equal(g.store.sq_norms[:n], j.store.sq_norms[:n])
    q = _data(4, 48)
    g.native_serve_max_batch = t.native_serve_max_batch = 0
    dg, ig = g.batch_search_slots(q, 10, ef=48)
    dt, it = t.batch_search_slots(q, 10, ef=48)
    np.testing.assert_array_equal(ig, it)
    np.testing.assert_array_equal(dg, dt)


def test_host_rerank_matches_jax(pair):
    j, t, _ = pair
    q = _data(10, 6)
    cand = np.random.default_rng(11).integers(-1, N, (6, 20))
    dj, ij = j._host_rerank(q, cand, 5)
    dt, it = t._host_rerank(q, cand, 5)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-6)


def test_mutations_match_jax():
    j, t, v = _build("cosine", seed=5)
    extra = _data(6, 20)
    for g in (j, t):
        assert g.delete("doc-3") and not g.delete("missing")
        g.add("doc-7", extra[0])                  # replaces doc-7
        g.batch_add([f"new-{i}" for i in range(19)], extra[1:])
    assert _host_equal(j, t)
    _serve_both(j, t, np.concatenate([extra[:4], _data(7, 60)]))
    assert t.search(extra[0], 1)[0][0] == "doc-7"
    assert "doc-3" not in t.keys()


def test_unported_modes_raise(tmp_path, monkeypatch):
    """The calls that raised until the device wave builder was ported
    (ROADMAP Queue 1 item 8) now work on a CPU graph."""
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")
    v = _data(8, 40)
    t = hnsw_tpu_torch.Graph(device="cpu")
    t.build(list(range(20)), v[:20], method="device")
    ckpt = str(tmp_path / "ckpt.npz")
    t.build(list(range(20, 30)), v[20:30], checkpoint_path=ckpt)
    t.build(list(range(30, 40)), v[30:], abort_deadline=0.0)
    t.refine()
    assert len(t) == 40 and t.host.count == 40
    assert t.search(v[25], 1)[0][0] == 25
    assert t.batch_delete([0, 99], refine=True) == [True, False]
    assert len(t) == 39 and t.lookup(0) is None
    assert hnsw_tpu_torch.Graph.resume_build(ckpt, device="cpu") \
        .host.count == 30
    assert t.mask_pending_for_serve() == 39
    d, i = hnsw_tpu_torch.Graph(device="cpu").batch_search_slots(
        _data(9, 3), 4)
    assert np.all(i == -1)
