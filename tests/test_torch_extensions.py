"""Facets, metadata, analyzer and checkpoint specs of hnsw_tpu_torch on the
CPU.

The facets, metadata and analyzer specs of tests/test_extensions.py run
against the port (``device="cpu"``), with the same names, and so do its
checkpoint specs that tests/test_torch_codec.py lacks. Beside them, on a
JAX graph carried into the port (``convert.graph_from_host_arrays``):
``FacetedGraph.batch_search_exact`` gives equal ids and distances within
1e-5 under every filter, and ``Analyzer`` equal metrics (the distortion
ratio, a mean of hop / distance ratios, within 1e-6 relative: distances
are f32 sums).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu_torch import (Analyzer, EqualityFilter, Facet,  # noqa: E402
                            FacetedGraph, MemoryFacetStore,
                            MemoryMetadataStore, MetadataGraph, RangeFilter,
                            SavedGraph, StringContainsFilter, export_graph,
                            import_graph, load_graph, save_graph)
from hnsw_tpu_torch.convert import graph_from_host_arrays  # noqa: E402
from hnsw_tpu_torch.index.hnsw import Graph as _Graph  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def Graph(**kw):
    return _Graph(device="cpu", **kw)


# ---------------------------------------------------------------- facets

def _faceted(n=60, d=8):
    v = make_vectors(n, d, seed=50)
    fg = FacetedGraph(Graph(seed=0))
    for i in range(n):
        fg.add(i, v[i], [
            Facet("category", "red" if i % 2 == 0 else "blue"),
            Facet("price", float(i)),
            Facet("title", f"item number {i}"),
        ])
    return fg, v


def test_faceted_equality_filter():
    fg, v = _faceted()
    res = fg.search(v[10], 5, [EqualityFilter("category", "red")])
    assert len(res) == 5
    assert all(int(k) % 2 == 0 for k, _ in res)
    assert res[0][0] == 10
    dists = [d for _, d in res]
    assert dists == sorted(dists)


def test_faceted_range_and_contains():
    fg, v = _faceted()
    res = fg.search(v[3], 5, [RangeFilter("price", min=20, max=40)])
    assert all(20 <= int(k) <= 40 for k, _ in res)
    res = fg.search(v[3], 3, [StringContainsFilter("title", "NUMBER 7")])
    assert all("7" in str(k) for k, _ in res)


def test_faceted_shortfall_requery():
    fg, v = _faceted()
    res = fg.search(v[41], 5, [RangeFilter("price", min=40, max=44)])
    assert res and res[0][0] == 41
    assert all(40 <= int(k) <= 44 for k, _ in res)
    assert fg.search(v[0], 3, [EqualityFilter("category", "green")]) == []


def test_faceted_rollback_on_store_failure():
    class FailingStore(MemoryFacetStore):
        def add(self, key, facets):
            raise RuntimeError("boom")

    fg = FacetedGraph(Graph(seed=0), FailingStore())
    with pytest.raises(RuntimeError):
        fg.add(1, np.ones(4, np.float32), [Facet("a", 1)])
    assert len(fg.graph) == 0


def test_facet_aggregations():
    fg, v = _faceted()
    agg = fg.facet_aggregations(v[0], 10, ["category"])
    assert set(agg) == {"category"}
    assert sum(agg["category"].values()) == 10


def test_batch_faceted_search():
    fg, v = _faceted()
    res = fg.batch_search(v[:3], 4, [EqualityFilter("category", "blue")])
    assert len(res) == 3
    for row in res:
        assert all(int(k) % 2 == 1 for k, _ in row)


def test_batch_search_exact_filtered_recall_one():
    from hnsw_tpu_torch.ops.distance import np_pairwise_dist
    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=90)
    fg = FacetedGraph(Graph(seed=0))
    fg.batch_add(list(range(n)), v,
                 [[Facet("bucket", 1 if i % 50 == 0 else 0)]
                  for i in range(n)])
    q = make_vectors(8, d, seed=91)
    res = fg.batch_search_exact(q, k, [EqualityFilter("bucket", 1)])
    allowed = np.array([i for i in range(n) if i % 50 == 0])
    dists = np_pairwise_dist(q, v[allowed], "cosine")
    for qi in range(8):
        want = [int(allowed[j]) for j in np.argsort(dists[qi])[:k]]
        got = [key for key, _ in res[qi]]
        assert got == want, (qi, got, want)
    res_all = fg.batch_search_exact(q, 1)
    d_all = np_pairwise_dist(q, v, "cosine")
    for qi in range(8):
        assert res_all[qi][0][0] == int(np.argmin(d_all[qi]))


def test_batch_search_exact_needs_vectors_on_the_device():
    fg, v = _faceted()
    fg.graph.hbm_mode = "quantized"
    with pytest.raises(ValueError, match="hbm_mode='full'"):
        fg.batch_search_exact(v[:2], 3)


# ---------------------------------------------------------------- meta

def test_metadata_round_trip():
    v = make_vectors(30, 8, seed=51)
    mg = MetadataGraph(Graph(seed=0))
    for i in range(30):
        mg.add(i, v[i], {"idx": i, "name": f"node{i}"})
    rec = mg.get(7)
    assert rec["metadata"]["name"] == "node7"
    np.testing.assert_array_equal(rec["vector"], v[7])
    res = mg.search(v[7], 3)
    assert res[0]["key"] == 7
    assert res[0]["metadata"]["idx"] == 7
    assert res[0]["dist"] < 1e-5
    assert res[1]["dist"] > 0


def test_metadata_json_string_and_invalid():
    mg = MetadataGraph(Graph(seed=0))
    mg.add(1, np.ones(4, np.float32), '{"a": 1}')
    assert mg.get(1)["metadata"] == {"a": 1}
    with pytest.raises(json.JSONDecodeError):
        mg.add(2, np.ones(4, np.float32), "{not json")
    assert len(mg) == 1


def test_metadata_batch_search_attaches():
    v = make_vectors(20, 8, seed=52)
    mg = MetadataGraph(Graph(seed=0))
    mg.batch_add(list(range(20)), v, [{"i": i} for i in range(20)])
    out = mg.batch_search(v[:2], 3)
    assert out[0][0]["metadata"]["i"] == 0
    assert out[1][0]["metadata"]["i"] == 1


def test_metadata_store_for_each_and_empty_store():
    store = MemoryMetadataStore()
    mg = MetadataGraph(Graph(seed=0), store)
    assert mg.store is store                 # an empty store is kept
    mg.add("a", np.ones(4, np.float32), [1, 2])
    seen = []
    store.for_each(lambda k, m: seen.append((k, m)))
    assert seen == [("a", [1, 2])]
    assert mg.delete("a") and len(store) == 0


# ---------------------------------------------------------------- analyzer

def test_analyzer_metrics():
    v = make_vectors(300, 16, seed=53)
    g = Graph(seed=0)
    g.batch_add(list(range(300)), v)
    a = Analyzer(g)
    assert a.height() == g.num_layers >= 2
    topo = a.topography()
    assert topo[0] == 300
    conn = a.connectivity()
    assert conn[0] > 4
    qm = a.quality_metrics()
    assert qm.node_count == 300
    assert qm.graph_height == a.height()
    assert qm.avg_connectivity > 4
    assert 0 <= qm.layer_balance <= 1


def test_analyzer_empty_graph():
    qm = Analyzer(Graph(seed=0)).quality_metrics()
    assert qm.node_count == 0
    assert qm.graph_height == 0


# ---------------------------------------------------------------- codec

def test_checkpoint_round_trip(tmp_path):
    v = make_vectors(150, 16, seed=54)
    g = Graph(seed=0, metric="l2")
    g.batch_add([f"k{i}" for i in range(150)], v)
    g.delete("k3")
    p = str(tmp_path / "graph.npz")
    save_graph(g, p)
    g2 = load_graph(p, device="cpu")
    assert len(g2) == 149
    assert g2.metric == "l2"
    np.testing.assert_array_equal(g2.lookup("k5"), v[5])
    assert g2.lookup("k3") is None
    q = make_vectors(5, 16, seed=55)
    k1, d1 = g.batch_search(q, 5)
    k2, d2 = g2.batch_search(q, 5)
    assert k1 == k2
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    g2.add("new", v[3])
    assert g2.search(v[3], 1)[0][0] == "new"


def test_checkpoint_atomic_replace(tmp_path):
    p = str(tmp_path / "g.npz")
    g = Graph(seed=0)
    g.add(1, np.ones(4, np.float32))
    save_graph(g, p)
    g.add(2, 2 * np.ones(4, np.float32))
    save_graph(g, p)
    g3 = load_graph(p, device="cpu")
    assert len(g3) == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_unknown_metric_rejected(tmp_path):
    g = Graph(seed=0)
    g.add(1, np.ones(4, np.float32))
    p = str(tmp_path / "g.npz")
    save_graph(g, p)
    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    cfg = json.loads(bytes(data["config"].tobytes()).decode())
    cfg["metric"] = "martian"
    data["config"] = np.frombuffer(json.dumps(cfg).encode(), dtype=np.uint8)
    np.savez(p, **data)
    with pytest.raises(ValueError, match="martian"):
        load_graph(p, device="cpu")


def test_saved_graph_wrapper(tmp_path):
    p = str(tmp_path / "s.npz")
    sg = SavedGraph.load(p, device="cpu")
    assert len(sg.graph) == 0
    sg.graph.add(1, np.ones(4, np.float32))
    sg.save()
    sg2 = SavedGraph.load(p, device="cpu")
    assert len(sg2.graph) == 1


def test_stream_export_import():
    import io as _io
    v = make_vectors(60, 8, seed=160)
    g = Graph(seed=0)
    g.batch_add(list(range(60)), v)
    buf = _io.BytesIO()
    export_graph(g, buf)
    buf.seek(0)
    g2 = import_graph(buf, device="cpu")
    assert len(g2) == 60
    assert g2.search(v[9], 1)[0][0] == 9


# -------------------------------------------- the JAX object beside the port

@pytest.fixture(scope="module", params=["cosine", "l2"])
def carried(request):
    """A JAX graph (deletes included) and the same graph in the port."""
    n, d = 2000, 16
    v = make_vectors(n, d, seed=170)
    keys = [f"doc-{i}" if i % 2 else i for i in range(n)]
    jg = hnsw_tpu.Graph(m=8, ef_construction=64, metric=request.param,
                        seed=0)
    jg.build(keys, v, method="host")
    jg.batch_delete(keys[5:200:15])
    n_used = jg.slots.capacity_used
    tg = graph_from_host_arrays(jg.cfg, jg.slots.slot_to_key,
                                jg.store.vectors[:n_used],
                                jg.store.alive[:n_used], *jg.host.arrays(),
                                device="cpu")
    return jg, tg, keys


def _facets(key):
    i = int(str(key).replace("doc-", ""))
    return [Facet("bucket", i % 100), Facet("name", f"item {i}")]


@pytest.mark.parametrize("filters", [
    (), (EqualityFilter("bucket", 7),), (RangeFilter("bucket", 10, 19),),
    (StringContainsFilter("name", "ITEM 1"), RangeFilter("bucket", max=50)),
])
def test_batch_search_exact_equals_jax(carried, filters):
    jg, tg, keys = carried
    jfg = hnsw_tpu.FacetedGraph(jg)
    tfg = FacetedGraph(tg)
    for key in keys:
        jfg.store.add(key, [hnsw_tpu.Facet(f.name, f.value)
                            for f in _facets(key)])
        tfg.store.add(key, _facets(key))
    jfilt = tuple(getattr(hnsw_tpu, type(f).__name__)(
        **{k: getattr(f, k) for k in f.__dataclass_fields__})
        for f in filters)
    q = make_vectors(21, 16, seed=171)
    rj = jfg.batch_search_exact(q, 10, jfilt)
    rt = tfg.batch_search_exact(q, 10, filters)
    assert [[k for k, _ in row] for row in rt] == \
        [[k for k, _ in row] for row in rj]
    np.testing.assert_allclose([d for row in rt for _, d in row],
                               [d for row in rj for _, d in row],
                               atol=1e-5, rtol=0)
    assert all(len(row) == 10 for row in rt)


def test_analyzer_equals_jax(carried):
    jg, tg, _ = carried
    ja, ta = hnsw_tpu.Analyzer(jg), Analyzer(tg)
    assert ta.height() == ja.height()
    assert ta.topography() == ja.topography()
    assert ta.connectivity() == ja.connectivity()
    jm, tm = ja.quality_metrics(seed=3), ta.quality_metrics(seed=3)
    for f in ("node_count", "avg_connectivity", "connectivity_std_dev",
              "layer_balance", "graph_height"):
        assert getattr(tm, f) == getattr(jm, f), f
    np.testing.assert_allclose(tm.distortion_ratio, jm.distortion_ratio,
                               rtol=1e-6)
