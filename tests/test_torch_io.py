"""Persistence of hnsw_tpu_torch on the CPU: table codecs, WAL, DiskGraph,
Arrow appender, codec and calibration snapshots.

Every spec of tests/test_io.py runs against the port (``device="cpu"``),
with the same names. Beside them: a DiskGraph directory written by
hnsw_tpu opens in the port and the reverse, with equal host arrays (keys,
levels, neighbours, entry, top) and searches that overlap >= 0.99 with
matched distances within 1e-5 (the bound of tests/test_torch_graph.py:
hop distances are f32 sums in another order). The appender specs skip
where pyarrow is missing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch import Graph, StoreConfig  # noqa: E402
from hnsw_tpu_torch.io import table as T  # noqa: E402
from hnsw_tpu_torch.io.appender import (AppenderConfig,  # noqa: E402
                                        ArrowAppender)
from hnsw_tpu_torch.io.disk_graph import DiskGraph as _DiskGraph  # noqa: E402
from hnsw_tpu_torch.io.wal import IncrementalStore  # noqa: E402
from tests.conftest import make_vectors  # noqa: E402

FMTS = ["parquet", "arrow", "npz"]


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


def DiskGraph(*a, **kw):
    return _DiskGraph(*a, device="cpu", **kw)


def _graph(**kw):
    return Graph(device="cpu", **kw)


# -------------------------------------------------------------- table codecs

@pytest.mark.parametrize("fmt", FMTS)
def test_vector_table_round_trip(fmt, tmp_path):
    v = make_vectors(20, 8, seed=70)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, list(range(20)), v, fmt)
    keys, vecs = T.read_vectors(p, fmt)
    assert keys == list(range(20))
    np.testing.assert_allclose(vecs, v, rtol=1e-6)


@pytest.mark.parametrize("fmt", FMTS)
def test_string_keys_round_trip(fmt, tmp_path):
    v = make_vectors(3, 4, seed=71)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, ["a", "b", "c"], v, fmt)
    keys, _ = T.read_vectors(p, fmt)
    assert keys == ["a", "b", "c"]


@pytest.mark.parametrize("fmt", FMTS)
def test_edges_round_trip(fmt, tmp_path):
    p = str(tmp_path / f"e.{T.ext_for(fmt)}")
    T.write_edges(p, np.array([0, 0, 1]), [1, 2, 3], [2, 3, 1], fmt)
    lids, keys, nbrs = T.read_edges(p, fmt)
    assert list(lids) == [0, 0, 1]
    assert keys == [1, 2, 3]
    assert nbrs == [2, 3, 1]


@pytest.mark.parametrize("fmt", FMTS)
def test_key_identity_round_trip(fmt, tmp_path):
    keys = ["1", 2, ("a", 3), "plain", b"\x00\xff", 2.5]
    v = make_vectors(len(keys), 4, seed=82)
    p = str(tmp_path / f"v.{T.ext_for(fmt)}")
    T.write_vectors(p, keys, v, fmt)
    got, _ = T.read_vectors(p, fmt)
    assert got == keys
    assert [type(k) for k in got] == [type(k) for k in keys]
    pe = str(tmp_path / f"e.{T.ext_for(fmt)}")
    T.write_edges(pe, np.array([0, 0]), ["1", ("a", 3)], [2, "1"], fmt)
    _, ek, en = T.read_edges(pe, fmt)
    assert ek == ["1", ("a", 3)] and en == [2, "1"]


# ------------------------------------------------------------------- WAL

def test_wal_overlay_and_get(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=3)
    v = make_vectors(5, 4, seed=72)
    w.record_add("a", v[0])
    w.record_add("b", v[1])
    found, vec = w.get_vector("a")
    assert found and np.allclose(vec, v[0])
    w.record_add("c", v[2])
    assert w.num_log_files == 1
    assert not w.pending
    found, vec = w.get_vector("b")
    assert found and np.allclose(vec, v[1])
    w.record_delete("a")
    found, vec = w.get_vector("a")
    assert found and vec is None
    ov = w.overlay()
    assert ov["a"] is None and np.allclose(ov["c"], v[2])


def test_wal_compaction(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=2,
                         max_log_files=1)
    v = make_vectors(6, 4, seed=73)
    for i in range(4):
        w.record_add(f"k{i}", v[i + 2])
    assert w.num_log_files == 2
    assert w.should_compact()
    w.record_delete("x")
    keys, vecs = w.compact(["x", "y"], v[:2])
    assert w.num_log_files == 0
    assert set(keys) == {"y", "k0", "k1", "k2", "k3"}
    got = dict(zip(keys, vecs))
    np.testing.assert_allclose(got["y"], v[1])
    np.testing.assert_allclose(got["k2"], v[4])


def test_wal_sync_writes_mode(tmp_path):
    w = IncrementalStore(str(tmp_path), fmt="npz", max_changes=1000,
                         sync_writes=True)
    v = make_vectors(2, 4, seed=86)
    w.record_add("a", v[0])
    assert not w.pending and w.num_log_files == 1
    w.record_delete("a")
    assert w.num_log_files == 2


@pytest.mark.parametrize("fmt", FMTS)
def test_wal_logs_cross_between_packages(fmt, tmp_path):
    """A log written by either package's WAL reads back in the other."""
    from hnsw_tpu.io.wal import IncrementalStore as JIncrementalStore
    v = make_vectors(4, 8, seed=87)
    for w_cls, r_cls, sub in ((JIncrementalStore, IncrementalStore, "j"),
                              (IncrementalStore, JIncrementalStore, "t")):
        w = w_cls(str(tmp_path / sub), fmt=fmt)
        for i in range(3):
            w.record_add(("k", i), v[i])
        w.record_delete(("k", 1))
        w.flush()
        ov = r_cls(str(tmp_path / sub), fmt=fmt).overlay()
        assert set(ov) == {("k", 0), ("k", 1), ("k", 2)}
        assert ov[("k", 1)] is None
        np.testing.assert_array_equal(ov[("k", 2)], v[2])


# ---------------------------------------------------------------- disk graph

@pytest.mark.parametrize("fmt", FMTS)
def test_disk_graph_close_reopen(fmt, tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(120, 16, seed=74)
    g = DiskGraph(d, fmt=fmt)
    g.batch_add(list(range(120)), v)
    res1 = g.search(v[7], 5)
    g.close()
    g2 = DiskGraph(d, fmt=fmt)
    assert len(g2) == 120
    res2 = g2.search(v[7], 5)
    assert res2[0][0] == 7
    assert [k for k, _ in res1] == [k for k, _ in res2]


def test_disk_graph_wal_replay_on_open(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(60, 8, seed=75)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(50)), v[:50])
    g.save()
    for i in range(50, 60):
        g.graph.add(i, v[i])
        g.wal.record_add(i, v[i])
    g.wal.record_delete(3)
    g.wal.flush()
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 59
    assert g2.search(v[55], 1)[0][0] == 55
    assert g2.graph.lookup(3) is None


def test_disk_graph_incremental_reopen_keeps_logs(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(70, 8, seed=77)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(60)), v[:60])
    g.save()
    g.wal.discard_logs()
    for i in range(60, 70):
        g.graph.add(i, v[i])
        g.wal.record_add(i, v[i])
    g.wal.record_delete(2)
    g.wal.flush()
    g._stop_flusher.set()
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 69
    assert g2.graph.lookup(2) is None
    assert g2.search(v[65], 1)[0][0] == 65
    assert g2.wal.num_log_files > 0
    g2._stop_flusher.set()
    g3 = DiskGraph(d, fmt="npz")
    assert len(g3) == 69
    assert g3.graph.lookup(2) is None
    assert g3.search(v[65], 1)[0][0] == 65
    g3.compact()
    assert g3.wal.num_log_files == 0
    g3._stop_flusher.set()
    g4 = DiskGraph(d, fmt="npz")
    assert len(g4) == 69 and g4.search(v[65], 1)[0][0] == 65


def test_disk_graph_quality_parity_with_memory(tmp_path):
    v = make_vectors(300, 16, seed=76)
    q = make_vectors(20, 16, seed=77)
    mem = _graph(seed=0)
    mem.batch_add(list(range(300)), v)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="parquet")
    dg.batch_add(list(range(300)), v)
    _, d_mem = mem.batch_search(q, 10, ef=60)
    _, d_dsk = dg.graph.batch_search(q, 10, ef=60)
    assert abs(float(np.mean(d_mem)) - float(np.mean(d_dsk))) < 0.1


def test_disk_graph_stats_and_compact(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(40, 8, seed=78)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(40)), v)
    g.optimize()
    s = g.stats()
    assert s["count"] == 40
    assert s["vectors_bytes"] > 0
    assert s["wal_log_files"] == 0


def test_disk_graph_wal_value_update_survives_reopen(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(30, 8, seed=81)
    g = DiskGraph(d, fmt="npz")
    g.batch_add(list(range(30)), v)
    g.save()
    new_vec = -v[5]
    g.graph.add(5, new_vec)
    g.wal.record_add(5, new_vec)
    g.wal.flush()
    g2 = DiskGraph(d, fmt="npz")
    np.testing.assert_allclose(g2.graph.lookup(5), new_vec)
    g2.close()
    g3 = DiskGraph(d, fmt="npz")
    np.testing.assert_allclose(g3.graph.lookup(5), new_vec)


def test_disk_graph_mixed_key_types_reopen(tmp_path):
    d = str(tmp_path / "dg")
    v = make_vectors(20, 8, seed=83)
    keys = [("t", i) if i % 3 == 0 else (str(i) if i % 3 == 1 else i)
            for i in range(20)]
    g = DiskGraph(d, fmt="npz")
    g.batch_add(keys, v)
    g.close()
    g2 = DiskGraph(d, fmt="npz")
    assert len(g2) == 20
    for i, k in enumerate(keys):
        got = g2.graph.lookup(k)
        assert got is not None, f"key {k!r} lost on reopen"
        np.testing.assert_allclose(got, v[i], rtol=1e-6)


def test_wal_age_based_background_flush(tmp_path):
    import time as _t
    d = str(tmp_path / "dg")
    g = DiskGraph(d, store_config=StoreConfig(
        directory=d, format="npz", wal_flush_interval_seconds=0.2,
        wal_max_changes=1000))
    v = make_vectors(3, 4, seed=85)
    g.add(0, v[0])
    assert g.wal.pending
    deadline = _t.time() + 10
    while g.wal.pending and _t.time() < deadline:
        _t.sleep(0.05)
    assert not g.wal.pending and g.wal.num_log_files == 1
    g.close()


def test_incremental_reopen_recall_parity(tmp_path):
    n, extra, d, k = 400, 40, 16, 10
    v = make_vectors(n + extra, d, seed=79)
    q = make_vectors(32, d, seed=80)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="npz")
    dg.batch_add(list(range(n)), v[:n])
    dg.save()
    dg.wal.discard_logs()
    for i in range(n, n + extra):
        dg.graph.add(i, v[i])
        dg.wal.record_add(i, v[i])
    dg.wal.flush()
    dg._stop_flusher.set()
    g2 = DiskGraph(str(tmp_path / "dg"), fmt="npz")
    assert len(g2) == n + extra
    fresh = _graph(seed=0)
    fresh.batch_add(list(range(n + extra)), v)
    from hnsw_tpu_torch.ops.topk import np_exact_topk
    _, gt = np_exact_topk(q, v, k, "cosine")

    def rec(graph):
        keys, _ = graph.batch_search(q, k, ef=80)
        return float(np.mean([len(set(row) & set(gt[i])) / k
                              for i, row in enumerate(keys)]))

    r_inc, r_fresh = rec(g2.graph), rec(fresh)
    assert r_inc >= r_fresh - 0.05, (r_inc, r_fresh)
    g2._stop_flusher.set()


def test_calibration_persists_through_disk_graph(tmp_path):
    n, d, k = 500, 16, 5
    v = make_vectors(n, d, seed=91)
    dg = DiskGraph(str(tmp_path / "dg"), fmt="parquet")
    dg.batch_add(list(range(n)), v)
    ef, rec = dg.graph.calibrate_ef(0.9, k=k)
    dg.save()
    dg.close()
    dg2 = DiskGraph(str(tmp_path / "dg"), fmt="parquet")

    def boom(*a, **kw):
        raise AssertionError("recalibration oracle scan ran on reopen")
    dg2.graph._host_oracle_slots = boom
    ef2, rec2 = dg2.graph.calibrate_ef(0.9, k=k)
    assert (ef2, rec2) == (ef, rec)
    dg2.close()


def _same_structure(a, b):
    """Equal host graphs of two Graphs (either package): key table,
    stored rows, levels, neighbours, entry, top."""
    n = a.slots.capacity_used
    assert n == b.slots.capacity_used
    assert a.slots.slot_to_key == b.slots.slot_to_key
    np.testing.assert_array_equal(a.store.vectors[:n], b.store.vectors[:n])
    np.testing.assert_array_equal(a.store.alive[:n], b.store.alive[:n])
    for x, y in zip(a.host.arrays(), b.host.arrays()):
        np.testing.assert_array_equal(x, y)
    assert (a.host.entry, a.host.top) == (b.host.entry, b.host.top)


def _searches_match(jg, tg, q):
    jg.native_serve_max_batch = tg.native_serve_max_batch = 0
    dj, ij = jg.batch_search_slots(q, 10, ef=64)
    dt, it = tg.batch_search_slots(q, 10, ef=64)
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ij, it))
    assert hits >= 0.99 * int((ij >= 0).sum())
    same = ij == it
    np.testing.assert_allclose(dt[same], dj[same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("fmt", ["parquet", "npz"])
def test_disk_graph_directories_cross_between_packages(fmt, tmp_path):
    """A directory written by hnsw_tpu.DiskGraph reopens in the port with
    equal host arrays and matching searches, and the reverse; the WAL
    delta and the calibration snapshot cross too."""
    n, d = 600, 16
    v = make_vectors(n + 20, d, seed=88)
    q = make_vectors(40, d, seed=89)
    keys = [f"doc-{i}" if i % 3 else i for i in range(n + 20)]

    def fill(dg):
        dg.batch_add(keys[:n], v[:n])
        dg.graph.calibrate_ef(0.9, k=5)
        dg.save()
        dg.wal.discard_logs()
        for i in range(n, n + 20):            # a small WAL delta
            dg.graph.add(keys[i], v[i])
            dg.wal.record_add(keys[i], v[i])
        dg.wal.record_delete(keys[7])
        dg.wal.flush()
        dg._stop_flusher.set()

    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jw = hnsw_tpu.DiskGraph(jd, fmt=fmt)
    fill(jw)
    tw = DiskGraph(td, fmt=fmt)
    fill(tw)
    _same_structure(jw.graph, tw.graph)
    for d_w, writer in ((jd, jw), (td, tw)):
        jr = hnsw_tpu.DiskGraph(d_w, fmt=fmt)
        tr = DiskGraph(d_w, fmt=fmt)
        for r in (jr, tr):
            r._stop_flusher.set()
            assert len(r) == n + 19 and r.graph.lookup(keys[7]) is None
            assert r.graph.calibration_state() == \
                writer.graph.calibration_state()
        _same_structure(jr.graph, tr.graph)
        _searches_match(jr.graph, tr.graph, q)
        assert tr.graph.device.type == "cpu"


@pytest.mark.parametrize("fmt", ["parquet", "npz"])
def test_mmap_vector_directories_cross_between_packages(fmt, tmp_path):
    """vectors_on_disk=True: the memory-mapped row file and its sidecars
    written by either package reopen in the other, rows equal."""
    from hnsw_tpu.config import StoreConfig as JStoreConfig
    n, d = 300, 8
    v = make_vectors(n, d, seed=90)
    for sub, w_make, r_make in (
            ("j", lambda p: hnsw_tpu.DiskGraph(p, store_config=JStoreConfig(
                directory=p, format=fmt, vectors_on_disk=True,
                wal_flush_interval_seconds=0)),
             lambda p: DiskGraph(p, store_config=StoreConfig(
                 directory=p, format=fmt, vectors_on_disk=True,
                 wal_flush_interval_seconds=0))),
            ("t", lambda p: DiskGraph(p, store_config=StoreConfig(
                directory=p, format=fmt, vectors_on_disk=True,
                wal_flush_interval_seconds=0)),
             lambda p: hnsw_tpu.DiskGraph(p, store_config=JStoreConfig(
                 directory=p, format=fmt, vectors_on_disk=True,
                 wal_flush_interval_seconds=0)))):
        p = str(tmp_path / sub)
        w = w_make(p)
        w.batch_add(list(range(n)), v)
        w.close()
        r = r_make(p)
        assert len(r) == n
        np.testing.assert_array_equal(np.asarray(r.graph.store.vectors[:n]),
                                      v)
        _same_structure(w.graph, r.graph)
        assert r.search(v[9], 1)[0][0] == 9


# ----------------------------------------------------------------- appender

def test_appender_stream():
    pa = pytest.importorskip("pyarrow")
    v = make_vectors(25, 8, seed=79)
    g = _graph(seed=0)
    app = ArrowAppender(g, AppenderConfig(batch_size=10))

    def batches():
        for i in range(0, 25, 5):
            yield pa.RecordBatch.from_pydict({
                "key": list(range(i, i + 5)),
                "vector": [v[j].tolist() for j in range(i, i + 5)],
            })

    assert app.stream_records(batches()) == 25
    assert len(g) == 25
    assert g.search(v[13], 1)[0][0] == 13


def test_appender_async_and_validation():
    pa = pytest.importorskip("pyarrow")
    v = make_vectors(10, 4, seed=80)
    g = _graph(seed=0)
    app = ArrowAppender(g)
    h = app.stream_records_async(iter([pa.RecordBatch.from_pydict({
        "key": list(range(10)),
        "vector": [x.tolist() for x in v],
    })]))
    assert h.result(30) == 10
    assert len(g) == 10
    bad = pa.RecordBatch.from_pydict({"key": [1], "vec": [[1.0]]})
    with pytest.raises(ValueError, match="vector"):
        app.append_record(bad)
    bad2 = pa.RecordBatch.from_pydict({"key": [1.5], "vector": [[1.0]]})
    with pytest.raises(ValueError, match="key field"):
        app.append_record(bad2)


# ------------------------------------------------------- codec, calibration

def test_checkpoint_is_pickle_free(tmp_path):
    v = make_vectors(25, 8, seed=84)
    g = _graph(seed=0)
    keys = [("k", i) if i % 2 else str(i) for i in range(25)]
    g.batch_add(keys, v)
    p = str(tmp_path / "g.npz")
    hnsw_tpu_torch.save_graph(g, p)
    g2 = hnsw_tpu_torch.load_graph(p, device="cpu")
    assert sorted(map(repr, g2.keys())) == sorted(map(repr, keys))
    assert g2.search(v[7], 1)[0][0] == keys[7]


def test_codec_int_key_fast_path_and_mixed_fallback(tmp_path):
    v = make_vectors(60, 8, seed=77)
    g = _graph(m=8, seed=0)
    g.batch_add(list(range(40)), v[:40])
    g.delete(3)
    p = str(tmp_path / "ints.npz")
    hnsw_tpu_torch.save_graph(g, p)
    with np.load(p) as z:
        assert "keys_int" in z.files and "keys_json" not in z.files
    g2 = hnsw_tpu_torch.load_graph(p, device="cpu")
    assert sorted(k for k in g2.slots.slot_to_key if k is not None) \
        == sorted(k for k in g.slots.slot_to_key if k is not None)
    assert all(type(k) is int for k in g2.slots.slot_to_key
               if k is not None)
    assert g2.search(v[7], 1)[0][0] == 7
    assert g2.slots.free == g.slots.free

    gm = _graph(m=8, seed=0)
    gm.batch_add([1, "a", (2, "b")] + list(range(10, 30)), v[:23])
    pm = str(tmp_path / "mixed.npz")
    hnsw_tpu_torch.save_graph(gm, pm)
    with np.load(pm) as z:
        assert "keys_json" in z.files
    gm2 = hnsw_tpu_torch.load_graph(pm, device="cpu")
    assert gm2.search(v[1], 1)[0][0] == "a"
    assert set(gm2.slots.slot_to_key) >= {1, "a", (2, "b")}


def test_calibration_persists_through_codec(tmp_path):
    n, d, k = 600, 24, 5
    v = make_vectors(n, d, seed=90)
    g = _graph(seed=0)
    g.batch_add(list(range(n)), v)
    ef, rec = g.calibrate_ef(0.9, k=k)
    assert g._ef_calib
    p = str(tmp_path / "calib.npz")
    hnsw_tpu_torch.save_graph(g, p)
    g2 = hnsw_tpu_torch.load_graph(p, device="cpu")

    def boom(*a, **kw):
        raise AssertionError("recalibration oracle scan ran on reopen")
    g2._host_oracle_slots = boom
    ef2, rec2 = g2.calibrate_ef(0.9, k=k)
    assert (ef2, rec2) == (ef, rec)
    assert g2.ef_search == ef


def test_hybrid_and_ivf_calibration_state_roundtrip():
    from hnsw_tpu_torch import HybridIndex, IVFIndex
    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=92)
    q = make_vectors(8, d, seed=93)
    ivf = IVFIndex(num_partitions=8, nprobe="auto", metric="cosine",
                   seed=0, auto_recall=0.8, device="cpu")
    ivf.build(list(range(n)), v)
    ivf.batch_search(q, k)
    st = ivf.calibration_state()
    assert st.get("auto_nprobe")
    ivf2 = IVFIndex(num_partitions=8, nprobe="auto", metric="cosine",
                    seed=0, auto_recall=0.8, device="cpu")
    ivf2.build(list(range(n)), v)
    ivf2.restore_calibration(st)

    def boom(*a, **kw):
        raise AssertionError("auto-nprobe recalibrated after restore")
    ivf2._calibrate_nprobe = boom
    assert ivf2._resolve_nprobe() == st["auto_nprobe"][0]

    hi = HybridIndex(exact_threshold=10, device="cpu")
    hi.batch_add(list(range(n)), v)
    hi.batch_search(q, k, target_recall=0.9)
    hst = hi.calibration_state()
    assert hst["routes"]
    hi2 = HybridIndex(exact_threshold=10, device="cpu")
    hi2.batch_add(list(range(n)), v)
    hi2.restore_calibration(hst)
    kk2, t2 = next(iter(hi2._calib.items()))
    kk1, t1 = next(iter(hi._calib.items()))
    assert kk1 == kk2 and t1 == t2


def test_disk_graph_default_format_needs_pyarrow(tmp_path, monkeypatch):
    """The default table format is "parquet", as in hnsw_tpu; where
    pyarrow is missing that raises and names fmt="npz"."""
    monkeypatch.setattr(T, "HAVE_ARROW", False)
    g = DiskGraph(str(tmp_path / "dg"))
    assert g.fmt == "parquet"
    g.batch_add(list(range(20)), make_vectors(20, 8, seed=94))
    with pytest.raises(RuntimeError, match="npz"):
        g.save()
    g._stop_flusher.set()
