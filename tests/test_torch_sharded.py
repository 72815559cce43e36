"""hnsw_tpu_torch.parallel against hnsw_tpu.parallel on the CPU.

Twins of tests/test_sharded.py: the JAX side runs on the virtual
8-device CPU mesh of tests/conftest.py, the port on ``Mesh(["cpu"] * 8)``,
both on the same seeded numpy inputs. Tolerances:

* exact paths (``sharded_exact_topk``, IVF at nprobe = P): ids equal to
  JAX's and to the numpy oracle, distances within 1e-5 of JAX's;
* capacity candidates: candidate sets equal to JAX's up to ties (an id
  in one set only lies within 1e-5 of the set's boundary distance);
* graph paths get the same DeviceGraph (``convert.device_graph_from_numpy``)
  or RowShards (``convert.row_shards_from_jax``) tensors and state an id
  overlap with JAX each; the row-sharded graph holds F2's measured
  contract against the single-device pivot-seeded search (overlap >= 0.9);
* ``PartitionedGraph`` carried across with ``convert.partitioned_from_jax``:
  keys equal to JAX's, recall >= 0.85;
* multihost: port ``ExactIndex(device="cpu")`` slices, keys equal to the
  JAX slices'. TCP servers bind 127.0.0.1 port 0, every SocketTransport
  has a request_timeout of 60 s or less, servers shut down in ``finally``.

Their CUDA twins are in tests/test_torch_cuda_parallel.py.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu  # noqa: E402
from hnsw_tpu.parallel import multihost as jmh  # noqa: E402
from hnsw_tpu.parallel.partitioned import _pad_graph as j_pad  # noqa: E402
from hnsw_tpu.parallel import rowsharded as jrs  # noqa: E402
from hnsw_tpu.parallel import rpc as jrpc  # noqa: E402
from hnsw_tpu.parallel import sharded as jsh  # noqa: E402
from hnsw_tpu_torch import ExactIndex  # noqa: E402
from hnsw_tpu_torch.convert import (device_graph_from_numpy,  # noqa: E402
                                    graph_from_host_arrays, ivf_from_jax,
                                    partitioned_from_jax,
                                    row_shards_from_jax)
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core.state import DeviceGraph  # noqa: E402
from hnsw_tpu_torch.ops.topk import np_exact_topk  # noqa: E402
from hnsw_tpu_torch.parallel import rowsharded as trs  # noqa: E402
from hnsw_tpu_torch.parallel import sharded as tsh  # noqa: E402
from hnsw_tpu_torch.parallel.multihost import (LocalTransport,  # noqa: E402
                                               MultiHostIndex)
from hnsw_tpu_torch.parallel.partitioned import _pad_graph  # noqa: E402
from hnsw_tpu_torch.parallel.rpc import (SliceServer,  # noqa: E402
                                         SocketTransport)
from tests.conftest import make_vectors  # noqa: E402

MESH = tsh.Mesh(["cpu"] * 8)
TIMEOUT = 30.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_dev(jdev):
    fields = {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                  else np.asarray(v))
              for k, v in jdev._asdict().items() if v is not None}
    return device_graph_from_numpy(fields, "cpu")


def _port_graph(jg):
    n = jg.slots.capacity_used
    return graph_from_host_arrays(jg.cfg, jg.slots.slot_to_key[:n],
                                  jg.store.vectors[:n], jg.store.alive[:n],
                                  *jg.host.arrays(), device="cpu")


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    hits = sum(len(set(map(int, x[x >= 0])) & set(map(int, y[y >= 0])))
               for x, y in zip(a, b))
    return hits / max(1, int((b >= 0).sum()))


def _matched_err(da, ia, db, ib):
    err = 0.0
    for rda, ria, rdb, rib in zip(da, ia, db, ib):
        pos = {int(x): p for p, x in enumerate(rib) if x >= 0}
        for p, x in enumerate(ria):
            if x >= 0 and int(x) in pos:
                err = max(err, abs(float(rda[p]) - float(rdb[pos[int(x)]])))
    return err


# ---- the mesh -------------------------------------------------------------

def test_virtual_devices_present():
    assert len(jax.devices()) == 8
    mesh = tsh.default_mesh(8, device="cpu")
    assert mesh.shape["data"] == 8 == jsh.default_mesh().shape["data"]
    assert mesh.devices == (torch.device("cpu"),) * 8 and mesh.one_device


def test_no_cpu_default_without_cuda(monkeypatch):
    """device=None means the card: without CUDA the mesh and every entry
    point that builds one raise instead of landing on the CPU."""
    from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip
    from hnsw_tpu_torch.parallel.partitioned import PartitionedGraph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (tsh.default_mesh, lambda: tsh.default_mesh(8),
                 PartitionedGraph, lambda: dryrun_multichip(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tsh.default_mesh(8, device="cpu").shape == {"data": 8}


# ---- row-sharded exact ------------------------------------------------------

def test_sharded_exact_matches_oracle():
    n, d, k = 512, 16, 7
    rng = np.random.default_rng(30)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((9, d)).astype(np.float32)
    sq = np.sum(v * v, axis=1).astype(np.float32)
    jd, ji = jsh.sharded_exact_topk(jnp.asarray(q), jnp.asarray(v),
                                    jnp.asarray(sq), jnp.ones(n, bool), k=k,
                                    metric="l2", mesh=jsh.default_mesh())
    td, ti = tsh.sharded_exact_topk(_t(q), _t(v), _t(sq),
                                    torch.ones(n, dtype=torch.bool), k=k,
                                    metric="l2", mesh=MESH)
    gt_d, gt_i = np_exact_topk(q, v, k, "l2")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), gt_i)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    # the same ids as one scan of the whole table, k past a shard's rows
    from hnsw_tpu_torch.ops.exact_screen import exact_scan
    d1, i1 = exact_scan(_t(q), _t(v), _t(sq), torch.ones(n, dtype=torch.bool),
                        k=80, metric="l2")
    d8, i8 = tsh.sharded_exact_topk(_t(q), _t(v), _t(sq),
                                    torch.ones(n, dtype=torch.bool), k=80,
                                    metric="l2", mesh=MESH)
    np.testing.assert_array_equal(i8.numpy(), i1.numpy())
    np.testing.assert_array_equal(d8.numpy(), d1.numpy())
    with pytest.raises(ValueError, match="divisible"):
        tsh.sharded_exact_topk(_t(q), _t(v[:500]), _t(sq[:500]),
                               torch.ones(500, dtype=torch.bool), k=k,
                               metric="l2", mesh=MESH)


# ---- query-sharded graph ------------------------------------------------------

def test_sharded_graph_search_matches_single_device():
    """Same DeviceGraph in both packages: the port's sharded search equals
    the JAX sharded search and the port's single-device search (ids at
    overlap 1.0, distances within 1e-5)."""
    rng = np.random.default_rng(31)
    v = rng.standard_normal((300, 16)).astype(np.float32)
    jg = hnsw_tpu.Graph(seed=0)
    jg.batch_add(list(range(300)), v)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    keys1, d1 = jg.batch_search(q, 5, ef=40)
    jdev = jg.device_graph()
    jd, ji = jsh.sharded_graph_search(jdev, jnp.asarray(q), k=5, ef=40,
                                      metric="cosine",
                                      mesh=jsh.default_mesh())
    tdev = _port_dev(jdev)
    td, ti = tsh.sharded_graph_search(tdev, _t(q), k=5, ef=40,
                                      metric="cosine", mesh=MESH)
    assert _overlap(ti.numpy(), np.asarray(ji)) == 1.0
    assert _matched_err(td.numpy(), ti.numpy(), np.asarray(jd),
                        np.asarray(ji)) <= 1e-5
    keys2 = [jg.slots.keys_for(row) for row in ti.numpy()]
    assert keys1 == keys2
    np.testing.assert_allclose(d1, td.numpy(), rtol=1e-4, atol=1e-5)
    sd, si = tsearch.search_graph(tdev, _t(q), k=5, ef=40, metric="cosine")
    np.testing.assert_array_equal(si.numpy(), ti.numpy())
    np.testing.assert_array_equal(sd.numpy(), td.numpy())
    with pytest.raises(ValueError, match="divisible"):
        tsh.sharded_graph_search(tdev, _t(q[:12]), k=5, ef=40, mesh=MESH)


# ---- partitioned graphs ---------------------------------------------------------

def test_partitioned_graph_search_recall():
    rng = np.random.default_rng(32)
    n_per, d, k = 100, 16, 5
    parts = [rng.standard_normal((n_per, d)).astype(np.float32)
             for _ in range(8)]
    jdevs = []
    for p in parts:
        gg = hnsw_tpu.Graph(seed=0, ef_construction=60)
        gg.batch_add(list(range(n_per)), p)
        jdevs.append(gg.device_graph())
    cap = max(g.cap for g in jdevs)
    L = max(g.num_layers for g in jdevs)
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[j_pad(g, cap, L) for g in jdevs])
    padded = [_pad_graph(_port_dev(g), cap, L, "cpu") for g in jdevs]
    tstacked = DeviceGraph(*(torch.stack(xs)
                             for xs in zip(*(g[:6] for g in padded))))
    q = rng.standard_normal((6, d)).astype(np.float32)
    jd, ji = jsh.partitioned_graph_search(jstacked, jnp.asarray(q), k=k,
                                          ef=60, metric="cosine",
                                          mesh=jsh.default_mesh())
    td, ti = tsh.partitioned_graph_search(tstacked, _t(q), k=k, ef=60,
                                          metric="cosine", mesh=MESH)
    ti = ti.numpy()
    assert _overlap(ti, np.asarray(ji)) >= 0.99
    assert _matched_err(td.numpy(), ti, np.asarray(jd), np.asarray(ji)) \
        <= 1e-5
    gt_d, gt_i = np_exact_topk(q, np.concatenate(parts), k, "cosine")
    p_, s_ = np.divmod(ti, cap)
    assert _overlap(p_ * n_per + s_, gt_i) >= 0.8


def test_partitioned_graph_class_end_to_end():
    from hnsw_tpu.parallel.partitioned import PartitionedGraph as JPG
    v = make_vectors(800, 16, seed=120, kind="clustered")
    jpg = JPG()
    jpg.build([f"k{i}" for i in range(800)], v, wave=128)
    pg = partitioned_from_jax(jpg, "cpu")
    assert len(pg) == 800 and pg.stats()["sizes"] == jpg.stats()["sizes"]
    q = make_vectors(12, 16, seed=121, kind="clustered")
    jkeys, jd = jpg.batch_search(q, 5, ef=60)
    keys, dists = pg.batch_search(q, 5, ef=60)
    assert keys == jkeys
    np.testing.assert_allclose(dists, jd, rtol=0, atol=1e-5)
    _, gt = np_exact_topk(q, v, 5, "cosine")
    hits = sum(len({int(k[1:]) for k in keys[i] if k is not None} &
                   set(map(int, gt[i]))) for i in range(12))
    assert hits / 60 >= 0.85
    # single + mutation, the partitioner carried across routes the adds
    assert pg.search(v[3], 1)[0][0] == "k3"
    assert pg.delete("k3")
    assert pg.search(v[3], 1)[0][0] != "k3"
    pg.add("new", v[3])
    assert pg.search(v[3], 1)[0][0] == "new"
    # a fresh port PartitionedGraph (its own partitioner, sub-graphs built
    # concurrently) builds the JAX sub-graphs and serves JAX's keys
    own = type(pg)(mesh=MESH)
    own.build([f"k{i}" for i in range(800)], v, wave=128)
    for g, jg in zip(own.graphs, jpg.graphs):
        assert g.slots.slot_to_key == jg.slots.slot_to_key
        for a, b in zip(g.host.arrays(), jg.host.arrays()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert own.batch_search(q, 5, ef=60)[0] == jkeys


# ---- multihost ---------------------------------------------------------------------

def test_multihost_shards_route_and_merge():
    n, d, k = 600, 16, 5
    v = make_vectors(n, d, seed=130)
    q = make_vectors(20, d, seed=131)
    jm = jmh.MultiHostIndex(jmh.LocalTransport(
        [hnsw_tpu.ExactIndex(metric="cosine") for _ in range(4)]))
    mh = MultiHostIndex(LocalTransport(
        [ExactIndex(metric="cosine", device="cpu") for _ in range(4)]))
    try:
        jm.batch_add(list(range(n)), v)
        mh.batch_add(list(range(n)), v)
        assert len(mh) == n
        st = mh.stats()
        assert st == jm.stats() and all(c > 0 for c in st["per_slice"])
        keys, dists = mh.batch_search(q, k)
        jkeys, jd = jm.batch_search(q, k)
        assert keys == jkeys
        np.testing.assert_allclose(dists, jd, rtol=0, atol=1e-5)
        _, gt_i = np_exact_topk(q, v, k, "cosine")
        for i in range(len(q)):
            assert keys[i] == [int(x) for x in gt_i[i]]
        assert mh.delete(5)
        assert not mh.delete(5)
        assert len(mh) == n - 1
        assert mh.search(v[5], 1)[0][0] != 5
    finally:
        mh.close()
        jm.close()


def test_multihost_replicas_survive_slice_loss():
    n, d = 200, 8
    v = make_vectors(n, d, seed=132)
    slices = [ExactIndex(metric="cosine", device="cpu") for _ in range(3)]
    jslices = [hnsw_tpu.ExactIndex(metric="cosine") for _ in range(3)]
    mh = MultiHostIndex(LocalTransport(slices), replicas=2)
    jm = jmh.MultiHostIndex(jmh.LocalTransport(jslices), replicas=2)
    try:
        mh.batch_add(list(range(n)), v)
        jm.batch_add(list(range(n)), v)
        assert len(mh) == n
        assert [len(s) for s in slices] == [len(s) for s in jslices]
        slices[1].batch_delete(slices[1].keys())
        jslices[1].batch_delete(jslices[1].keys())
        keys, _ = mh.batch_search(v[:32], 1)
        assert [r[0] for r in keys] == list(range(32))
        assert keys == jm.batch_search(v[:32], 1)[0]
    finally:
        mh.close()
        jm.close()


def _serve(make_index, n_slices, tr_cls, **kw):
    servers = [SliceServer(make_index()) if tr_cls is SocketTransport
               else jrpc.SliceServer(make_index()) for _ in range(n_slices)]
    addrs = [s.start() for s in servers]
    return servers, tr_cls(addrs, request_timeout=TIMEOUT, **kw)


def _shutdown(servers, tr):
    tr.close()
    for s in servers:
        try:
            s.shutdown()
        except OSError:
            pass


def test_multihost_over_tcp_sockets():
    n, d, k = 400, 16, 5
    v = make_vectors(n, d, seed=132)
    q = make_vectors(10, d, seed=133)
    keys_in = [("doc", i) if i % 2 else i for i in range(n)]
    out = {}
    for name, tr_cls, mk in (
            ("port", SocketTransport,
             lambda: ExactIndex(metric="cosine", device="cpu")),
            ("jax", jrpc.SocketTransport,
             lambda: hnsw_tpu.ExactIndex(metric="cosine"))):
        servers, tr = _serve(mk, 3, tr_cls)
        mh_cls = (MultiHostIndex if name == "port" else jmh.MultiHostIndex)
        mh = mh_cls(tr, replicas=2)
        try:
            mh.batch_add(keys_in, v)
            st = mh.stats()
            assert all(c > 0 for c in st["per_slice"])
            keys, dists = mh.batch_search(q, k)
            out[name] = (keys, dists, st)
            gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
            for i in range(len(q)):
                assert keys[i] == [keys_in[int(x)] for x in gt_i[i]]
                np.testing.assert_allclose(dists[i], gt_d[i], atol=1e-5)
            assert mh.delete(keys_in[7])
            assert mh.search(v[7], 1)[0][0] != keys_in[7]
            with pytest.raises(RuntimeError, match="not allowed"):
                tr.call(0, "device_graph")
            assert tr.call(0, "__len__") > 0
        finally:
            mh.close()
            _shutdown(servers, tr)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][2] == out["jax"][2]
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0,
                               atol=1e-5)


def test_multihost_tcp_dead_slice_failover_and_reconnect():
    n, d = 200, 8
    v = make_vectors(n, d, seed=134)
    idxs = [ExactIndex(metric="cosine", device="cpu") for _ in range(3)]
    servers = [SliceServer(ix) for ix in idxs]
    addrs = [s.start() for s in servers]
    tr = SocketTransport(addrs, timeout=5.0, retry_backoff=0.05,
                         request_timeout=TIMEOUT)
    mh = mh1 = None
    try:
        mh = MultiHostIndex(tr, replicas=2)
        mh.batch_add(list(range(n)), v)
        # (b) a restarted server on the same port is reconnected
        assert tr.call(0, "__len__") > 0
        servers[0].shutdown()
        servers[0] = SliceServer(idxs[0], host=addrs[0][0], port=addrs[0][1])
        servers[0].start()
        assert tr.call(0, "__len__") > 0
        # (a) a dead slice: replicas still cover every key
        servers[1].shutdown()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            keys, _ = mh.batch_search(v[:32], 1)
        assert [r[0] for r in keys] == list(range(32))
        # the JAX index over the same vectors answers the same
        jm = jmh.MultiHostIndex(jmh.LocalTransport(
            [hnsw_tpu.ExactIndex(metric="cosine") for _ in range(3)]),
            replicas=2)
        jm.batch_add(list(range(n)), v)
        assert keys == jm.batch_search(v[:32], 1)[0]
        jm.close()
        # (c) no replicas: a dead slice is an error, not silent loss
        mh1 = MultiHostIndex(tr, replicas=1)
        with pytest.raises(Exception):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mh1.batch_search(v[:4], 1)
    finally:
        for m in (mh, mh1):
            if m is not None:
                m.close()
        _shutdown(servers, tr)


def test_multihost_raises_when_failures_reach_replica_count():
    n, d = 120, 8
    v = make_vectors(n, d, seed=140)

    def flaky(base):
        class Flaky(base):
            dead = set()

            def call(self, slice_id, method, *args, **kw):
                if slice_id in self.dead:
                    raise ConnectionError(f"slice {slice_id} down")
                return super().call(slice_id, method, *args, **kw)
        return Flaky

    tr = flaky(LocalTransport)(
        [ExactIndex(metric="cosine", device="cpu") for _ in range(4)])
    jtr = flaky(jmh.LocalTransport)(
        [hnsw_tpu.ExactIndex(metric="cosine") for _ in range(4)])
    mh = MultiHostIndex(tr, replicas=2)
    jm = jmh.MultiHostIndex(jtr, replicas=2)
    try:
        mh.batch_add(list(range(n)), v)
        jm.batch_add(list(range(n)), v)
        tr.dead = jtr.dead = {1}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            keys, _ = mh.batch_search(v[:8], 1)
            assert keys == jm.batch_search(v[:8], 1)[0]
        assert [r[0] for r in keys] == list(range(8))
        tr.dead = {1, 2}
        with pytest.raises(ConnectionError):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mh.batch_search(v[:8], 1)
    finally:
        mh.close()
        jm.close()


def test_multihost_over_capacity_mode_slices():
    rng = np.random.default_rng(77)
    n, d, k = 3000, 32, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    slices = [ExactIndex(metric="cosine", hbm_dtype="int8", device="cpu")
              for _ in range(4)]
    jslices = [hnsw_tpu.ExactIndex(metric="cosine", hbm_dtype="int8")
               for _ in range(4)]
    for s in slices + jslices:
        s.host_serve_max_batch = 0
    mh = MultiHostIndex(LocalTransport(slices))
    jm = jmh.MultiHostIndex(jmh.LocalTransport(jslices))
    try:
        mh.batch_add(list(range(n)), v)
        jm.batch_add(list(range(n)), v)
        q = rng.standard_normal((16, d)).astype(np.float32)
        keys, dists = mh.batch_search(q, k)
        jkeys, _ = jm.batch_search(q, k)
        _, gt = np_exact_topk(q, v, k, "cosine")
        rec = np.mean([len({kk for kk in keys[r] if kk is not None}
                           & set(gt[r])) / k for r in range(16)])
        assert rec >= 0.95, f"multihost capacity recall {rec}"
        same = np.mean([len(set(keys[r]) & set(jkeys[r])) / k
                        for r in range(16)])
        assert same >= 0.99, f"port vs JAX key overlap {same}"
        keys2, _ = mh.batch_search(v[:8], 1)
        assert [row[0] for row in keys2] == list(range(8))
    finally:
        mh.close()
        jm.close()


# ---- capacity candidates ----------------------------------------------------------

def _same_up_to_ties(td, ti, jd, ji, tol=1e-5):
    """Per row: the candidate sets agree, except ids within ``tol`` of the
    set's boundary distance (an equal-distance cut)."""
    for rtd, rti, rjd, rji in zip(td, ti, jd, ji):
        edge = max(float(rtd.max()), float(rjd.max()))
        only_t = set(map(int, rti)) - set(map(int, rji))
        only_j = set(map(int, rji)) - set(map(int, rti))
        dt = dict(zip(map(int, rti), map(float, rtd)))
        dj = dict(zip(map(int, rji), map(float, rjd)))
        assert all(dt[i] >= edge - tol for i in only_t), (only_t, edge)
        assert all(dj[i] >= edge - tol for i in only_j), (only_j, edge)


def test_sharded_quantized_candidates_int8_and_bf16():
    import ml_dtypes
    n, d, k, kk = 4096, 32, 10, 26
    rng = np.random.default_rng(60)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((32, d)).astype(np.float32)
    sq = np.sum(v.astype(np.float64) * v, axis=1).astype(np.float32)
    _, gt = np_exact_topk(q, v, k, "cosine")
    jmesh = jsh.default_mesh()
    alive = np.ones((n,), bool)
    amax = np.max(np.abs(v), axis=1)
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    v8 = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
    cases = [("int8", v8, v8, s, kk, 0.95),
             ("bf16", v.astype(ml_dtypes.bfloat16),
              _t(v).to(torch.bfloat16), None, k + 4, 0.99),
             ("fp16", v.astype(np.float16), v.astype(np.float16), None,
              k + 4, 0.99)]
    for name, jtab, ttab, sc, kk_, floor in cases:
        jd, ji = jsh.sharded_quantized_candidates(
            jnp.asarray(q), jnp.asarray(jtab),
            None if sc is None else jnp.asarray(sc), jnp.asarray(sq),
            jnp.asarray(alive), kk=kk_, metric="cosine", mesh=jmesh)
        td, ti = tsh.sharded_quantized_candidates(
            _t(q), ttab if isinstance(ttab, torch.Tensor) else _t(ttab),
            None if sc is None else _t(sc), _t(sq), _t(alive), kk=kk_,
            metric="cosine", mesh=MESH)
        ti = ti.numpy()
        assert ti.shape == (32, kk_) and 0 <= ti.min() and ti.max() < n
        _same_up_to_ties(td.numpy(), ti, np.asarray(jd), np.asarray(ji))
        rec = np.mean([len(set(ti[r]) & set(gt[r])) / k for r in range(32)])
        assert rec >= floor, f"{name} containment {rec}"


# ---- block-sharded IVF ------------------------------------------------------------

def _ivf_shards(blocks, block_sq, block_valid, part_blocks, S, lib):
    NB = blocks.shape[0]
    nb_pad = -(-NB // S) * S
    block_part = np.full(nb_pad, -1, np.int32)
    for p, bl in enumerate(part_blocks):
        block_part[bl] = p
    pad = nb_pad - NB
    if lib == "jax":
        return (jnp.pad(blocks, ((0, pad), (0, 0), (0, 0))),
                jnp.pad(block_sq, ((0, pad), (0, 0))),
                jnp.pad(block_valid, ((0, pad), (0, 0))),
                jnp.asarray(block_part), pad)
    F = torch.nn.functional
    return (F.pad(blocks, (0, 0, 0, 0, 0, pad)), F.pad(block_sq, (0, 0, 0, pad)),
            F.pad(block_valid, (0, 0, 0, pad)), _t(block_part), pad)


def test_sharded_ivf_candidates_matches_single_device():
    from hnsw_tpu.index.ivf import IVFIndex as JIVF
    rng = np.random.default_rng(33)
    n, d, k, P = 800, 24, 6, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((12, d)).astype(np.float32)
    jivf = JIVF(num_partitions=P, nprobe=P, metric="cosine", seed=0)
    jivf.build(list(range(n)), v)
    ivf = ivf_from_jax(jivf, "cpu")
    jb, jbsq, jbv, jslot, jc, jpb = jivf._sync()
    tb, tbsq, tbv, tslot, tc, tpb = ivf._sync()
    jargs = _ivf_shards(jb, jbsq, jbv, jpb, 8, "jax")
    targs = _ivf_shards(tb, tbsq, tbv, tpb, 8, "torch")

    def slots(ids, block_slot, pad):
        # the packages lay rows out in their own member-set order: compare
        # store slots, decoded through each package's block table
        flat = np.pad(block_slot, ((0, pad), (0, 0)),
                      constant_values=-1).reshape(-1)
        ids = np.asarray(ids)
        return np.where(ids >= 0, flat[np.clip(ids, 0, None)], -1)

    jd, ji = jsh.sharded_ivf_candidates(jnp.asarray(q), jc, *jargs[:4],
                                        nprobe=P, k=k, metric="cosine",
                                        mesh=jsh.default_mesh())
    td, ti = tsh.sharded_ivf_candidates(_t(q), tc, *targs[:4], nprobe=P,
                                        k=k, metric="cosine", mesh=MESH)
    gt_d, gt_i = np_exact_topk(q, v, k, "cosine")
    t_slots = slots(ti, tslot, targs[-1])
    np.testing.assert_array_equal(t_slots, gt_i)
    np.testing.assert_array_equal(t_slots, slots(ji, jslot, jargs[-1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    # a partial probe equals the single-device IVF at the same nprobe
    keys1, _ = ivf.batch_search(q, k, _nprobe=4)
    _, ti2 = tsh.sharded_ivf_candidates(_t(q), tc, *targs[:4], nprobe=4, k=k,
                                        metric="cosine", mesh=MESH)
    _, ji2 = jsh.sharded_ivf_candidates(jnp.asarray(q), jc, *jargs[:4],
                                        nprobe=4, k=k, metric="cosine",
                                        mesh=jsh.default_mesh())
    keys2 = [[ivf.slots.keys_for(np.asarray([s]))[0] if s >= 0 else None
              for s in row] for row in slots(ti2, tslot, targs[-1])]
    assert keys1 == keys2
    np.testing.assert_array_equal(slots(ti2, tslot, targs[-1]),
                                  slots(ji2, jslot, jargs[-1]))


# ---- row-sharded single graph -------------------------------------------------------

@pytest.fixture(scope="module")
def rowgraph():
    rng = np.random.default_rng(33)
    n, d, nq = 4096, 64, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    jg = hnsw_tpu.Graph(m=8, seed=0, ef_construction=60)
    jg.build(list(range(n)), v, wave=512)
    return jg, v, q


def test_rowsharded_single_graph_recall_and_parity(rowgraph):
    """Recall >= 0.85 against the oracle; id overlap with the JAX
    row-sharded search on the same RowShards >= 0.99; F2's contract:
    overlap >= 0.9 with the single-device pivot-seeded search on the same
    graph (measured 1.0 here; the JAX test asserts the same bound)."""
    jg, v, q = rowgraph
    k, ef, nq = 10, 128, len(q)
    jshards = jrs.make_row_shards(jg, 8)
    shards = row_shards_from_jax(jshards, "cpu")
    assert shards.nbr0.shape[0] % 8 == 0
    jd, ji = jrs.rowsharded_graph_search(jshards, jnp.asarray(q), k=k, ef=ef,
                                         seeds=16, expand=2,
                                         mesh=jsh.default_mesh())
    td, ti = trs.rowsharded_graph_search(shards, _t(q), k=k, ef=ef, seeds=16,
                                         expand=2, mesh=MESH)
    ti = ti.numpy()
    assert _overlap(ti, np.asarray(ji)) >= 0.99
    assert _matched_err(td.numpy(), ti, np.asarray(jd), np.asarray(ji)) \
        <= 1e-5
    _, gt_i = np_exact_topk(q, v, k, "cosine")
    rec = _overlap(ti, gt_i)
    assert rec >= 0.85, f"row-sharded recall {rec:.3f}"
    # F2: against the single-device pivot-seeded beam on the same graph
    g = _port_graph(jg)
    g.entry_mode = "pivots"
    dev = g.device_graph()
    pids, pvecs, psq = g._pivot_arrays()
    seeds = tsearch.pivot_seeds(_t(q), pvecs, psq, pids, s=16,
                                metric="cosine")
    _, i1 = tsearch.search_graph(dev, _t(q), k=k, ef=ef, metric="cosine",
                                 expand=2, seed_ids=seeds, merge="bitonic")
    overlap = _overlap(ti, i1.numpy())
    assert overlap >= 0.9, f"single-device parity overlap {overlap:.3f}"
    # make_row_shards of the port's graph gives the JAX tensors
    own = trs.make_row_shards(g, 8)
    for f in ("nbr0", "vectors", "sq_norms", "pivot_ids", "pivot_vecs",
              "pivot_sq"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(jshards, f)))


def test_rowsharded_stacked_equals_shard_loop(rowgraph):
    """The two exchanges (module docstring): bit-equal ids and distances."""
    jg, _, q = rowgraph
    shards = trs.make_row_shards(_port_graph(jg), 8)
    kw = dict(k=10, ef=64, seeds=16, metric="cosine", max_hops=128,
              expand=2)
    a = trs._search(trs._StackedRows(shards, MESH, "data"),
                    *shards[3:], _t(q), **kw)
    b = trs._search(trs._ShardLoopRows(shards, MESH, "data"),
                    *shards[3:], _t(q), **kw)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_rowsharded_fp16_capacity_rows():
    rng = np.random.default_rng(34)
    n, d, k = 2048, 32, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    jg = hnsw_tpu.Graph(m=8, seed=0)
    jg.build(list(range(n)), v, wave=512)
    g = _port_graph(jg)
    s32 = trs.make_row_shards(g, 8)
    s16 = trs.make_row_shards(g, 8, dtype="float16")
    assert s16.vectors.dtype == torch.float16
    j16 = jrs.make_row_shards(jg, 8, dtype="float16")
    np.testing.assert_array_equal(s16.vectors.numpy(), np.asarray(j16.vectors))
    _, i32 = trs.rowsharded_graph_search(s32, _t(q), k=k, ef=64, mesh=MESH)
    _, i16 = trs.rowsharded_graph_search(s16, _t(q), k=k, ef=64, mesh=MESH)
    _, j16i = jrs.rowsharded_graph_search(j16, jnp.asarray(q), k=k, ef=64,
                                          mesh=jsh.default_mesh())
    overlap = _overlap(i16.numpy(), i32.numpy())
    assert overlap >= 0.9, f"fp16 rows overlap {overlap:.3f}"
    assert _overlap(i16.numpy(), np.asarray(j16i)) >= 0.99


def test_rowsharded_prefolds_deleted_nodes():
    rng = np.random.default_rng(35)
    n, d, k = 1024, 32, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    jg = hnsw_tpu.Graph(m=8, seed=0)
    jg.build(list(range(n)), v, wave=512)
    dead = list(range(0, n, 7))
    jg.batch_delete(dead)
    g = _port_graph(jg)
    shards = trs.make_row_shards(g, 8)
    np.testing.assert_array_equal(shards.nbr0.numpy(),
                                  np.asarray(jrs.make_row_shards(jg, 8).nbr0))
    q = v[1:9] + 0.01 * rng.standard_normal((8, d)).astype(np.float32)
    _, ik = trs.rowsharded_graph_search(shards, _t(q), k=k, ef=64,
                                        mesh=MESH)
    dead_set = set(dead)
    assert not any(int(s) in dead_set for row in ik.numpy() for s in row
                   if s >= 0)
