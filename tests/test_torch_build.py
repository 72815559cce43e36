"""The wave builder's device functions: hnsw_tpu_torch.core.build /
build_device against hnsw_tpu.core.build / build_device on the CPU.

The same seeded numpy inputs go through both packages. Tolerances:

* integer-valued vectors (|x| <= 4) make every product and sum exact in
  f32 and every operand exact in bf16, so the port's DEFAULT (bf16
  operands) and JAX's CPU DEFAULT (f32) score alike: selected rows and
  updated tables must be EQUAL for l2, sqeuclidean and dot, ties
  included (both packages break them to the lower index). Cosine goes
  through rsqrt, which may differ by an ulp: row overlap >= 0.99.
* construction_descent: per-layer overlap of the distinct candidate ids
  >= 0.99 (the pools merge in another order, which can resolve a tie
  differently), matched distances within 1e-5.
* _row_dist_dense / _cand_dist_dev on Gaussian rows: within 1e-5.
* A single-wave device build (513 nodes: the bootstrap node plus one
  512-wide wave) on integer-valued l2 data: levels, entry and layer 0
  EQUAL to JAX's. Upper layers hold only layer members (JAX's also link
  the bootstrap node where it is not a member, fault F9), and overlap
  JAX's member edges >= 0.9.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.core import build as jbuild  # noqa: E402
from hnsw_tpu.core import build_device as jbd  # noqa: E402
from hnsw_tpu.core import state as jstate  # noqa: E402
from hnsw_tpu_torch import Graph  # noqa: E402
from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.core import build_device as tbd  # noqa: E402
from hnsw_tpu_torch.core import state as tstate  # noqa: E402
from hnsw_tpu_torch.ops.distance import INF_DIST  # noqa: E402

METRICS = ["l2", "sqeuclidean", "dot", "cosine"]


def _ints(seed, n, d, lo=-4, hi=4):
    r = np.random.default_rng(seed)
    return r.integers(lo, hi + 1, (n, d)).astype(np.float32)


def _sq(v):
    return np.sum(v.astype(np.float64) ** 2, axis=1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(row):
    return set(row[row >= 0].tolist())


def _row_overlap(a, b):
    """Share of b's distinct ids per row that a's row holds too."""
    hits = sum(len(_ids(x) & _ids(y)) for x, y in zip(a, b))
    return hits / max(1, sum(len(_ids(y)) for y in b))


def _repeats(rows):
    """Rows that hold some id twice."""
    return [r for r, row in enumerate(rows)
            if len(_ids(row)) < int((row >= 0).sum())]


def _candidates(seed, n_vec, P, C, metric, vecs):
    """[P, C] candidate ids with duplicates and -1 pads, scored against
    an anchor per row (duplicates carry equal distances), INF on pads."""
    r = np.random.default_rng(seed)
    ci = r.integers(0, n_vec, (P, C)).astype(np.int32)
    ci[:, C // 2] = ci[:, 1]                        # a duplicate per row
    ci[r.random((P, C)) < 0.15] = -1                # pads
    anchors = r.integers(0, n_vec, P)
    d = tbuild._np_dist_rows(vecs, _sq(vecs), anchors[:, None],
                             np.clip(ci, 0, None), metric)
    cd = np.where(ci >= 0, d, INF_DIST).astype(np.float32)
    return ci, cd


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_diverse_select_dev_matches_jax(metric, diversify):
    vecs = _ints(0, 300, 16)
    sq = _sq(vecs)
    ci, cd = _candidates(1, 300, 96, 40, metric, vecs)
    want = np.asarray(jbuild._diverse_select_dev(
        jnp.asarray(ci), jnp.asarray(cd), jnp.asarray(vecs), jnp.asarray(sq),
        deg=12, metric=metric, diversify=diversify))
    got = tbuild._diverse_select_dev(_t(ci), _t(cd), _t(vecs), _t(sq),
                                     deg=12, metric=metric,
                                     diversify=diversify).numpy()
    assert got.shape == want.shape == (96, 12)
    if metric == "cosine":
        assert _row_overlap(got, want) >= 0.99
    else:
        np.testing.assert_array_equal(got, want)
    # the numpy host version is a copy of the JAX package's
    np.testing.assert_array_equal(
        tbuild.diverse_select(ci, cd.astype(np.float64), vecs, sq, 12,
                              metric, diversify),
        jbuild.diverse_select(ci, cd.astype(np.float64), vecs, sq, 12,
                              metric, diversify))


def _reverse_case(seed, with_map):
    """A layer table, edges with -1 pads and many distance ties, and
    (``with_map``) a compact slot -> row map with unmapped slots."""
    r = np.random.default_rng(seed)
    cap, Wd, E = 256, 12, 700
    vecs = _ints(seed, cap, 8, -2, 2)
    rows_n = 64 if with_map else cap
    row_of = None
    if with_map:
        row_of = np.full(cap, -1, np.int32)
        row_of[r.choice(cap, rows_n, replace=False)] = np.arange(rows_n)
    nb = np.stack([r.permutation(cap)[:Wd] for _ in range(rows_n)])
    nb[r.random((rows_n, Wd)) < 0.3] = -1
    tgt = r.integers(0, cap, E).astype(np.int32)
    src = r.integers(0, cap, E).astype(np.int32)
    tgt[r.random(E) < 0.1] = -1
    src[tgt < 0] = -1
    return vecs, _sq(vecs), nb.astype(np.int32), tgt, src, row_of


@pytest.mark.parametrize("diversify", [False, True])
@pytest.mark.parametrize("with_map", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "dot"])
def test_reverse_update_matches_jax(metric, with_map, diversify):
    vecs, sq, nb, tgt, src, row_of = _reverse_case(3, with_map)
    deg = 8
    want = np.asarray(jbd._reverse_update(
        jnp.asarray(nb), jnp.asarray(vecs), jnp.asarray(sq),
        jnp.asarray(tgt), jnp.asarray(src), deg=deg, metric=metric,
        diversify=diversify,
        row_of=None if row_of is None else jnp.asarray(row_of)))
    t_nb = _t(nb.copy())
    out = tbd._reverse_update(t_nb, _t(vecs), _t(sq), _t(tgt), _t(src),
                              deg=deg, metric=metric, diversify=diversify,
                              row_of=None if row_of is None else _t(row_of))
    assert out is t_nb                  # in place
    np.testing.assert_array_equal(out.numpy(), want)
    assert not np.array_equal(want, nb)


def test_scatter_rows_skips_rows_past_the_table():
    nb = torch.full((6, 3), -1, dtype=torch.int32)
    rows = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    tbd._scatter_rows(nb, torch.tensor([2, 6, 0, 9], dtype=torch.int32),
                      rows)
    want = np.asarray(jbd._scatter_rows(
        jnp.full((6, 3), -1, jnp.int32), jnp.asarray([2, 6, 0, 9]),
        jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(nb.numpy(), want)
    assert (nb[5] == -1).all()          # no clamped write to the last row


@pytest.mark.parametrize("metric", METRICS)
def test_row_and_candidate_distances_match_jax(metric):
    r = np.random.default_rng(4)
    vecs = (r.standard_normal((200, 24)) / np.sqrt(24)).astype(np.float32)
    sq = _sq(vecs)
    anchors = r.integers(-1, 200, 50).astype(np.int32)
    others = r.integers(-1, 200, (50, 30)).astype(np.int32)
    # no self pairs: sqrt of the Gram form's rounding residue at distance
    # 0 is ~1e-3 in either package (ops/distance.py's numerical note)
    others[others == anchors[:, None]] = -1
    args_j = [jnp.asarray(a) for a in (vecs, sq, anchors, others)]
    args_t = [_t(a) for a in (vecs, sq, anchors, others)]
    for jf, tf in ((jbd._row_dist_dense, tbd._row_dist_dense),
                   (jbuild._cand_dist_dev, tbuild._cand_dist_dev)):
        want = np.asarray(jf(*args_j, metric))
        got = tf(*args_t, metric).numpy()
        assert ((got >= INF_DIST) == (want >= INF_DIST)).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_construction_descent_candidates_match_jax():
    v = _ints(5, 1200, 16)
    g = Graph(m=8, ef_construction=48, metric="l2", seed=0, device="cpu")
    g.build(list(range(1200)), v, method="host")
    nb, levels, entry, _ = g.host.arrays()
    n = g.slots.capacity_used
    sq = _sq(v)
    alive = np.ones(n, bool)
    jg = jstate.from_host(v, sq, nb[:, :n], levels[:n], alive, entry)
    tg = tstate.from_host(v, sq, nb[:, :n], levels[:n], alive, entry,
                          device="cpu")
    q = _ints(6, 64, 16)
    jd, ji = (np.asarray(x) for x in jbuild.construction_descent(
        jg, jnp.asarray(q), ef=48, m_out=24, metric="l2", max_hops=64))
    td, ti = (x.numpy() for x in tbuild.construction_descent(
        tg, _t(q), ef=48, m_out=24, metric="l2", max_hops=64))
    assert ti.shape == ji.shape == (g.num_layers, 64, 24)
    for layer in range(g.num_layers):
        assert _row_overlap(ti[layer], ji[layer]) >= 0.99, layer
        same = ti[layer] == ji[layer]
        np.testing.assert_allclose(td[layer][same], jd[layer][same],
                                   rtol=0, atol=1e-5)
    # the pool's dedup assumes a repeated id sits next to its twin after
    # the sort by distance, which an exact tie with a third id breaks
    # (hnsw_tpu/core/search.py:47-52; integer rows tie often): both
    # packages keep the same repeats, and _diverse_select_dev drops them
    assert _repeats(ti[0]) == _repeats(ji[0]) != []


def test_compact_upper_tables_and_sparse_sync_round_trip():
    v = _ints(7, 900, 16)
    g = Graph(m=8, seed=2, device="cpu")
    g.build(list(range(900)), v, method="host")
    host = g.host
    ncap = host.neighbors.shape[1]
    cap_pad = tstate.bucket_pow2(ncap)
    L = host.neighbors.shape[0]
    lv_all = np.full(cap_pad, -1, np.int32)
    lv_all[:ncap] = host.levels[:ncap]
    assert L > 2
    ups, counts, tabs, umap = tbd._compact_upper_tables(
        host, lv_all, cap_pad, L, 8, "cpu")
    j_ups, j_counts, j_tabs, j_umap = jbd._compact_upper_tables(
        host, lv_all, cap_pad, L, 8)
    np.testing.assert_array_equal(ups, j_ups)
    assert counts == j_counts
    np.testing.assert_array_equal(umap.numpy(), np.asarray(j_umap))
    for a, b in zip(tabs, j_tabs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    before = host.neighbors.copy()
    nb0 = tstate.upload(host.neighbors[0], -1, (cap_pad, 16), "cpu")
    host.neighbors[:] = 7                # clobber, then restore
    tbd._sparse_sync(host, nb0, tabs, ups, counts, ncap)
    np.testing.assert_array_equal(host.neighbors, before)


def test_single_wave_build_equals_jax(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")
    n = 513
    v = _ints(8, n, 16)
    j = hnsw_tpu.Graph(m=8, metric="l2", seed=3)
    t = Graph(m=8, metric="l2", seed=3, device="cpu")
    for g in (j, t):
        g.build(list(range(n)), v, method="device", wave=512)
    (j_nb, j_lv, j_entry, j_top), (t_nb, t_lv, t_entry, t_top) = (
        j.host.arrays(), t.host.arrays())
    np.testing.assert_array_equal(t_nb[0, :n], j_nb[0, :n])
    np.testing.assert_array_equal(t_lv[:n], j_lv[:n])
    assert (t_entry, t_top) == (j_entry, j_top) and t_top >= 1
    assert t.host.count == j.host.count == n
    assert_upper_members(t_nb[:, :n], t_lv[:n])
    for layer in range(1, t_top + 1):
        j_rows = np.where(j_lv[np.clip(j_nb[layer, :n], 0, None)] >= layer,
                          j_nb[layer, :n], -1)
        assert _row_overlap(t_nb[layer, :n], j_rows) >= 0.9, layer


def assert_upper_members(nb, levels):
    """Upper-layer rows are empty below the node's level and point only at
    nodes of that level or higher."""
    for layer in range(1, nb.shape[0]):
        edge = nb[layer] >= 0
        assert not edge[levels < layer].any(), layer
        tgt = np.where(edge, nb[layer], 0)
        assert (levels[tgt][edge] >= layer).all(), layer


def _wave_case(seed, metric):
    """A wave of W nodes in a 400-row integer-valued store: snapshot
    candidates with duplicates and -1 pads, the intra-wave distances
    (diagonal INF; integer rows give many ties), a participant list with
    -1 pads and an in-layer mask."""
    r = np.random.default_rng(seed)
    vecs = _ints(seed, 400, 16, -2, 2)
    W, n_cand = 64, 24
    wslots = r.choice(400, W, replace=False).astype(np.int32)
    cand_i = r.integers(0, 400, (W, n_cand)).astype(np.int32)
    cand_i[:, 5] = cand_i[:, 2]
    cand_i[r.random((W, n_cand)) < 0.2] = -1
    cand_d = r.random((W, n_cand)).astype(np.float32)   # unused: rescored
    wv = vecs[wslots]
    intra = tbuild._np_dist_rows(wv, _sq(wv), np.arange(W)[:, None],
                                 np.arange(W)[None, :], metric)
    np.fill_diagonal(intra, INF_DIST)
    part = np.full(W, -1, np.int32)
    members = np.flatnonzero(r.random(W) < 0.6)
    part[:len(members)] = members
    in_layer = np.zeros(W, bool)
    in_layer[members] = True
    return (vecs, _sq(vecs), cand_d, cand_i, intra.astype(np.float32),
            wslots, part, in_layer, n_cand)


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "dot"])
def test_assemble_rows_match_jax(metric, diversify):
    """Wave rows (rescored snapshot candidates + the intra_k nearest
    in-layer wave nodes, ties to the lower wave index) and refine rows
    (self excluded) are EQUAL to JAX's on integer-valued rows."""
    (vecs, sq, cand_d, cand_i, intra, wslots, part, in_layer,
     n_cand) = _wave_case(11, metric)
    kw = dict(deg=12, n_cand=n_cand, metric=metric, diversify=diversify)
    want = np.asarray(jbd._assemble_wave_rows(
        *(jnp.asarray(a) for a in (vecs, sq, cand_d, cand_i, intra, wslots,
                                   part, in_layer)), intra_k=16, **kw))
    got = tbd._assemble_wave_rows(
        *(_t(a) for a in (vecs, sq, cand_d, cand_i, intra, wslots, part,
                          in_layer)), intra_k=16, **kw).numpy()
    assert got.shape == want.shape == (64, 12)
    np.testing.assert_array_equal(got, want)
    # refine rows: a wave node's own slot among its candidates is dropped
    cand_i[:, 0] = wslots
    want = np.asarray(jbd._assemble_refine_rows(
        *(jnp.asarray(a) for a in (vecs, sq, cand_d, cand_i, wslots, part)),
        **kw))
    got = tbd._assemble_refine_rows(
        *(_t(a) for a in (vecs, sq, cand_d, cand_i, wslots, part)),
        **kw).numpy()
    np.testing.assert_array_equal(got, want)
    live = part >= 0
    assert not (got[live] == wslots[part[live]][:, None]).any()


@pytest.mark.parametrize("diversify", [False, True])
def test_batch_reverse_insert_matches_jax(diversify):
    """The host-authoritative reverse update: the layer array after it is
    EQUAL to JAX's (integer rows, l2, ties included), and the device
    pair / row distances agree within 1e-5."""
    vecs, sq, nb, tgt, src, _ = _reverse_case(12, False)
    ok = tgt >= 0
    tgt, src = tgt[ok].astype(np.int64), src[ok].astype(np.int64)
    j_nb, t_nb = nb.copy(), nb.copy()
    jv, jsq, tv, tsq = jnp.asarray(vecs), jnp.asarray(sq), _t(vecs), _t(sq)
    jbuild.batch_reverse_insert(j_nb, jv, jsq, tgt, src, 8, "l2",
                                diversify=diversify)
    tbuild.batch_reverse_insert(t_nb, tv, tsq, tgt, src, 8, "l2",
                                diversify=diversify)
    np.testing.assert_array_equal(t_nb, j_nb)
    assert not np.array_equal(t_nb, nb)
    np.testing.assert_allclose(
        tbuild._dev_pair_dist(tv, tsq, tgt, src, "l2"),
        jbuild._dev_pair_dist(jv, jsq, tgt, src, "l2"), rtol=0, atol=1e-5)
    anchors = np.unique(tgt)
    rows = nb[anchors].astype(np.int64)
    np.testing.assert_allclose(
        tbuild._dev_row_dist(tv, tsq, anchors, rows, "l2"),
        jbuild._dev_row_dist(jv, jsq, anchors, rows, "l2"), rtol=0,
        atol=1e-5)

