"""The host-authoritative wave builder and refinement on the CPU:
hnsw_tpu_torch.core.build.bulk_insert and core/build_device.refine_device
against hnsw_tpu's, and Graph.refine's contract (tests/test_build.py,
tests/test_compact_upper.py) run through the port.

Integer-valued vectors (|x| <= 4) make every product and sum exact in f32
and every operand exact in bf16, so the port's DEFAULT (bf16 operands)
and JAX's CPU DEFAULT (f32) score alike. Tolerances are stated per test;
the Graph contract keeps the JAX package's thresholds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.core import build as jbuild  # noqa: E402
from hnsw_tpu.core import build_device as jbd  # noqa: E402
from hnsw_tpu_torch import Graph  # noqa: E402
from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.core import build_device as tbd  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def _ints(seed, n, d, lo=-4, hi=4):
    r = np.random.default_rng(seed)
    return r.integers(lo, hi + 1, (n, d)).astype(np.float32)


def _ids(row):
    return set(row[row >= 0].tolist())


def _row_overlap(a, b):
    """Share of b's distinct ids per row that a's row holds too."""
    hits = sum(len(_ids(x) & _ids(y)) for x, y in zip(a, b))
    return hits / max(1, sum(len(_ids(y)) for y in b))


def _stored(g, v):
    """Assign keys 0..n-1 and store their vectors; returns the slots."""
    slots = g.slots.assign_fresh_batch(list(range(len(v))))
    g.store.put_batch(slots, v)
    return np.asarray(slots, np.int64)


def test_host_bulk_insert_matches_jax():
    """core/build.bulk_insert (host arrays authoritative, the sequential
    level loop) over two waves (the bootstrap node, a 256-wide wave, then
    the remaining 43) on integer-valued l2 rows: levels EQUAL to JAX's
    from the same seed; layer-0 rows overlap JAX's >= 0.99 (the second
    wave descends upper layers without JAX's non-member edges, fault
    F9), upper rows hold only layer members."""
    v = _ints(13, 300, 16)
    j = hnsw_tpu.Graph(m=8, metric="l2", seed=4)
    t = Graph(m=8, metric="l2", seed=4, device="cpu")
    jbuild.bulk_insert(j.host, _stored(j, v), wave=256)
    tbuild.bulk_insert(t.host, _stored(t, v), wave=256, device="cpu")
    (t_nb, t_lv, t_entry, t_top), (j_nb, j_lv, j_entry, j_top) = (
        t.host.arrays(), j.host.arrays())
    np.testing.assert_array_equal(t_lv[:300], j_lv[:300])
    assert _row_overlap(t_nb[0, :300], j_nb[0, :300]) >= 0.99
    assert (t_entry, t_top) == (j_entry, j_top) and t_top >= 1
    assert t.host.count == 300
    for layer in range(1, t_nb.shape[0]):
        edge = t_nb[layer, :300] >= 0
        assert not edge[t_lv[:300] < layer].any()
        tgt = np.where(edge, t_nb[layer, :300], 0)
        assert (t_lv[tgt][edge] >= layer).all()


@pytest.mark.parametrize("local", [False, True])
def test_refine_device_matches_jax(local):
    """refine_device over a natively built graph (equal host arrays in
    both packages): the refined layers' rows overlap JAX's >= 0.99 per
    layer on integer-valued l2 rows (the descent's pool merge may break a
    tie another way, as in construction_descent). ``local`` re-selects
    layer 0 only from a 3-hop beam seeded with the current rows."""
    n = 400
    v = _ints(14, n, 16)
    j = hnsw_tpu.Graph(m=8, metric="l2", seed=5)
    t = Graph(m=8, metric="l2", seed=5, device="cpu")
    for g in (j, t):
        g.build(list(range(n)), v, method="host")
    before = t.host.neighbors[:, :n].copy()
    np.testing.assert_array_equal(before, j.host.neighbors[:, :n])
    jbd.refine_device(j.host, wave=256, local=local)
    tbd.refine_device(t.host, wave=256, local=local, device="cpu")
    t_nb, j_nb = t.host.neighbors[:, :n], j.host.neighbors[:, :n]
    for layer in range(t_nb.shape[0]):
        assert _row_overlap(t_nb[layer], j_nb[layer]) >= 0.99, layer
    assert not np.array_equal(t_nb[0], before[0])
    if local:
        np.testing.assert_array_equal(t_nb[1:], before[1:])


def test_refine_with_a_slate_narrower_than_the_degree():
    """ef_construction below the layer-0 degree gives rows narrower than
    the table (n_cand = 8 < 2m = 32); the port pads them. (The JAX package
    raises a shape error on this path: ROADMAP Queue 3, fault F7.)"""
    v = _ints(15, 700, 16)
    g = Graph(m=16, ef_construction=8, metric="l2", seed=6, device="cpu")
    g.build(list(range(700)), v, method="device", wave=512)
    g.refine(wave=256)
    assert g.batch_delete(list(range(0, 90, 3)), refine=True)[0]
    assert g.host.neighbors.shape[2] == 32
    hit = [g.search(v[i], 1)[0][0] == i for i in range(100, 140)]
    assert np.mean(hit) >= 0.95


def _data(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


def _recall(g, q, gt, k=10, ef=80):
    g.native_serve_max_batch = 0
    keys, _ = g.batch_search(q, k, ef=ef)
    return float(np.mean([len({kk for kk in keys[i] if kk is not None}
                              & set(map(int, gt[i][:k]))) / k
                          for i in range(len(gt))]))


def test_refine_preserves_and_improves():
    v = _data(140, 600, 24)
    g = Graph(device="cpu")
    g.build(list(range(600)), v, method="device", wave=128)
    q = _data(141, 30, 24)
    _, gt = np_exact_topk(q, v, 10, "cosine")
    r0 = _recall(g, q, gt)
    g.refine(wave=256)
    assert _recall(g, q, gt) >= r0 - 0.02
    assert g.search(v[11], 1)[0][0] == 11


def test_device_build_compact_uppers_incremental_and_refine():
    """Two device builds onto one graph (the second respects the upper
    rows of the first), served through the compact upper layout, then
    refined."""
    n, d, k = 800, 24, 10
    v = _data(55, n, d)
    q = _data(56, 40, d)
    _, gt = np_exact_topk(q, v, k, "cosine")
    g = Graph(m=8, device="cpu")
    g.build(list(range(400)), v[:400], wave=256, method="device")
    g.build(list(range(400, n)), v[400:], wave=256, method="device")
    assert len(g) == n
    g.split_layers = "compact"
    r = _recall(g, q, gt)
    assert r >= 0.85, r
    assert isinstance(g.device_graph().nbr_upper, tuple)
    g.refine(wave=256)
    assert _recall(g, q, gt) >= r - 0.05
