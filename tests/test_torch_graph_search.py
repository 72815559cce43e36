"""K5's plain version and its routing, on the CPU.

``core/search.search_graph`` runs a whole search as one launch of the CUDA
kernel K5 (``ops/graph_search``) where
``ops/graph_search.search_kernel_applies`` holds; everywhere else, and on
the CPU always, it runs ``search_graph_reference`` (one
``beam_search_layer`` a layer). Here:

  (a) ``search_graph_reference`` against ``hnsw_tpu.core.search.
      search_graph`` on the same host arrays and queries, on an
      integer-valued graph (every distance exact in f32 and in bf16, so
      the port's bf16 rounding at DEFAULT and the JAX CPU backend's f32
      agree): descent and seeded entry (-1 pads, repeated seeds), dense,
      split and compact upper layers, f32 / fp16 / bf16 stores, the int8
      store with and without device vectors, int8 and fp16 neighbour
      blocks, ``fast_math`` on and off, ``device_rerank`` on and off,
      ``ef_upper`` 0 and 16: ids equal but within a tie (copies of a row),
      distances within 1e-5 x max(1, |d|); int8 blocks on Gaussian rows
      at the JAX package's bound (ids overlap >= 0.99, shared ids' distances
      within 1e-5 x max(1, |d|)), since on integer rows the JAX CPU
      backend's sums of the blocks' bf16 squares steer hops apart;
  (b) a step model of the kernel (one query at a time, as a block runs
      it: the entries scored in the upper layers' row mode, each layer
      from one entry, the hand-off of a pool's best where it has one, the
      seeds cut to the pool, the rerank's stable rank by counting) gives
      the plain version's rows and its per-layer hop counts as the
      largest per-query count;
  (c) the predicate: each layout's layer modes as ``ops/beam_search.
      layer_mode`` names them, the block's shared memory as the larger
      layer's layout plus the entries, the reasons it refuses a search,
      ``plain_on_cuda``'s counts; a CPU graph never loads the library;
      the one-copy read of the kernel's output buffer; the wrapper hands
      the launch its merge and outputs and counts it once; only K2, not
      K5, asks the L2 cache for rows ahead.

The card's tests of the kernel are ``tests/test_torch_cuda_graph_search.py``
(marked ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu.core import search as jsearch  # noqa: E402
from hnsw_tpu.core import state as jstate  # noqa: E402
from hnsw_tpu_torch.convert import device_graph_from_numpy  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.ops import graph_search as gs  # noqa: E402
from hnsw_tpu_torch.ops.distance import (DEFAULT, HIGHEST,  # noqa: E402
                                         INF_DIST, gathered_dist,
                                         register_distance)

INF = float(INF_DIST)
#: name -> from_host keyword arguments (the same for both packages but
#: the bf16 store's dtype)
LAYOUTS = {"dense": {}, "split": dict(split_layers=True, upper_m=4),
           "compact": dict(split_layers="compact", upper_m=4),
           "fp16-store": dict(store_dtype=np.float16),
           "bf16-store": dict(store_dtype="bfloat16"),
           "int8-store": dict(quantize=True),
           "quantized": dict(quantize=True, hbm_vectors=False),
           "int8-blocks": dict(block_layout=True, block_dtype="int8"),
           "fp16-blocks": dict(block_layout=True, block_dtype="float16")}


def _jax_kw(kw):
    if kw.get("store_dtype") == "bfloat16":
        return {**kw, "store_dtype": jnp.bfloat16}
    return kw


@pytest.fixture(scope="module")
def host():
    """A natively built l2 graph on integer-valued rows (entries in -2..2,
    D = 16, a fifth of them copies; m = 6, ml 0.3: several layers, 1,200
    rows, tombstones) as from_host arguments, and 16 integer queries."""
    r = np.random.default_rng(11)
    v = r.integers(-2, 3, (1200, 16)).astype(np.float32)
    v[1000:] = v[:200]
    g = hnsw_tpu_torch.Graph(m=6, ml=0.3, ef_construction=48, metric="l2",
                             seed=3, device="cpu")
    g.build(list(range(len(v))), v, method="host")
    g.batch_delete(list(range(0, 1200, 40)))
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    arrays = (g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
              levels[:n], g.store.alive[:n], entry)
    q = r.integers(-2, 3, (16, 16)).astype(np.float32)
    return arrays, q


@pytest.fixture(scope="module")
def gauss():
    """The same build on Gaussian rows (1,200 x 16, no copies) and 16
    Gaussian queries: int8 blocks are compared there, as
    tests/test_torch_block_search.py compares them."""
    r = np.random.default_rng(12)
    v = r.standard_normal((1200, 16)).astype(np.float32)
    g = hnsw_tpu_torch.Graph(m=6, ml=0.3, ef_construction=48, metric="l2",
                             seed=3, device="cpu")
    g.build(list(range(len(v))), v, method="host")
    g.batch_delete(list(range(0, 1200, 40)))
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    return ((g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
             levels[:n], g.store.alive[:n], entry),
            r.standard_normal((16, 16)).astype(np.float32))


def _seeds(B, seed=0):
    """[B, 6] seed slots: a repeated id and a -1 pad among valid slots."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, 1150, (B, 6)).astype(np.int32)
    ids[:, 1] = ids[:, 0]
    ids[:, 3] = -1
    return ids


def _graphs(host, layout):
    arrays, q = host
    kw = LAYOUTS[layout]
    jg = jstate.from_host(*arrays, metric="sqeuclidean", **_jax_kw(kw))
    fields = {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                  else np.asarray(v))
              for k, v in jg._asdict().items() if v is not None}
    return jg, device_graph_from_numpy(fields, "cpu"), q


def _close(dt, it, dj, ij, exact=True):
    """The JAX package's bounds: ids overlapping >= 0.99 a row and the
    distances of shared ids within 1e-5 x max(1, |d|); with ``exact``
    also the distances a position within it and the ids equal but within
    a run of equal distances (copies of a row: the packages may order a
    tie apart)."""
    hits, err = 0, 0.0
    for rdt, rit, rdj, rij in zip(dt, it, dj, ij):
        pos = {int(x): p for p, x in enumerate(rit) if x >= 0}
        for p, x in enumerate(rij):
            if x >= 0 and int(x) in pos:
                hits += 1
                a, b = float(rdt[pos[int(x)]]), float(rdj[p])
                err = max(err, abs(a - b) / max(1.0, abs(b)))
    assert hits >= 0.99 * int((ij >= 0).sum()) and err <= 1e-5, (hits, err)
    if exact:
        assert ((it >= 0) == (ij >= 0)).all()
        gap = np.abs(dt - dj) / np.maximum(1.0, np.abs(dj))
        assert float(gap[it >= 0].max(initial=0.0)) <= 1e-5
        tied = np.zeros_like(dj, bool)
        tied[:, 1:] |= dj[:, 1:] == dj[:, :-1]
        tied[:, :-1] |= dj[:, :-1] == dj[:, 1:]
        np.testing.assert_array_equal(np.where(tied, 0, it),
                                      np.where(tied, 0, ij))


@pytest.mark.parametrize("layout,entry,fast_math,rerank,ef_upper", [
    ("dense", "descent", False, True, 0),
    ("dense", "descent", True, True, 16),
    ("dense", "seeded", True, False, 0),
    ("split", "descent", False, True, 16),
    ("compact", "descent", True, True, 0),
    ("fp16-store", "descent", True, True, 0),
    ("bf16-store", "seeded", True, True, 0),
    ("int8-store", "descent", False, True, 0),
    ("quantized", "descent", True, True, 0),
    ("quantized", "seeded", False, False, 0),
    ("int8-blocks", "seeded", True, True, 0),
    ("fp16-blocks", "seeded", False, True, 16)])
def test_reference_matches_jax(host, gauss, layout, entry, fast_math,
                               rerank, ef_upper):
    # int8 blocks: on integer rows the JAX CPU backend's sums of the
    # blocks' bf16 squares part from the port's and steer hops apart
    int8_blocks = layout == "int8-blocks"
    jg, tg, q = _graphs(gauss if int8_blocks else host, layout)
    seeds = _seeds(len(q)) if entry == "seeded" else None
    kw = dict(k=8, ef=24, metric="sqeuclidean", max_hops=48, expand=2,
              merge="bitonic" if fast_math else "sort", fast_math=fast_math,
              device_rerank=rerank, ef_upper=ef_upper)
    dj, ij = jsearch.search_graph(
        jg, jnp.asarray(q),
        seed_ids=None if seeds is None else jnp.asarray(seeds), **kw)
    stats = {}
    dt, it = tsearch.search_graph_reference(
        tg, torch.from_numpy(q), stats=stats,
        seed_ids=None if seeds is None else torch.from_numpy(seeds), **kw)
    _close(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij),
           exact=not int8_blocks)
    assert len(stats["hops"]) == (1 if seeds is not None
                                  else tg.num_layers)
    assert (it.numpy()[:, 0] >= 0).all()


# --------------------------------------------------------------------------
# (b) a step model of the kernel
# --------------------------------------------------------------------------

def _kernel_steps(g, q, *, k, ef, metric, max_hops, fast_math, expand,
                  ef_upper, device_rerank, seed_ids, merge):
    """K5's steps in plain torch, a query at a time (a block each): returns
    (dists [B, k], ids [B, k], hops [layers, B])."""
    precision = DEFAULT if fast_math else HIGHEST
    P0 = max(ef, k)
    P_up = ef_upper if ef_upper > 0 else min(8, P0)
    q_sq = torch.sum(q * q, dim=-1)
    rerank = (device_rerank and (fast_math or g.qvec is not None)
              and g.vectors.shape[0] > 1)
    out_d, out_i, hops = [], [], []
    for b in range(q.shape[0]):
        qb, sb = q[b:b + 1], q_sq[b:b + 1]
        # 1. the entries in the upper layers' row mode; the seeds cut to
        # the pool
        ids = (torch.as_tensor([int(g.entry)], dtype=torch.int32)
               if seed_ids is None else seed_ids[b, :min(seed_ids.shape[1],
                                                        P0)])
        d = tsearch._score_hop(g, qb, sb, torch.clamp(ids, 0, g.cap - 1)
                               [None], metric, precision)[0]
        d = torch.where(ids >= 0, d, INF)
        ids = torch.where(ids >= 0, ids, -1)
        layer_kw = dict(max_hops=max_hops, metric=metric,
                        precision=precision, merge=merge)
        hb = []
        layers = range(g.num_layers - 1, 0, -1) if seed_ids is None else ()
        for layer in layers:
            st = {}
            pd, pi = tsearch.beam_search_layer_reference(
                g, layer, qb, sb, ids[None], d[None], P_up,
                expand=min(expand, P_up), stats=st, **layer_kw)
            hb.append(st["hops"][0])
            # 2. the hand-off: the pool's best, where it has one
            if float(pd[0, 0]) < INF and int(pi[0, 0]) >= 0:
                ids, d = pi[0, :1], pd[0, :1]
        st = {}
        pd, pi = tsearch.beam_search_layer_reference(
            g, 0, qb, sb, ids[None], d[None], P0, expand=expand, stats=st,
            **layer_kw)
        hb.append(st["hops"][0])
        pd, pi = pd[0], pi[0]
        if rerank:
            # 4. the rerank: f32 distances, a stable rank by counting
            R = min(P0, max(2 * k, 16))
            ri = pi[:R]
            safe = torch.clamp(ri, 0, g.cap - 1).long()
            rd = gathered_dist(qb, g.vectors[safe][None], g.sq_norms[safe]
                               [None], sb, metric=metric,
                               precision=HIGHEST)[0]
            rd = torch.where(ri >= 0, rd, INF).numpy()
            rank = [int(((rd < x) | ((rd == x) & (np.arange(R) < r))).sum())
                    for r, x in enumerate(rd)]
            od = np.full(k, INF, np.float32)
            oi = np.full(k, -1, np.int32)
            for r, p in enumerate(rank):
                if p < k:
                    od[p] = rd[r]
                    oi[p] = -1 if rd[r] >= INF else int(ri[r])
            pd, pi = torch.from_numpy(od), torch.from_numpy(oi)
        out_d.append(pd[:k])
        out_i.append(pi[:k])
        hops.append(hb)
    return (torch.stack(out_d), torch.stack(out_i),
            np.asarray(hops, np.int64).T)


@pytest.mark.parametrize("layout,entry,fast_math,rerank", [
    ("dense", "descent", True, True), ("compact", "descent", False, True),
    ("quantized", "seeded", False, False), ("bf16-store", "seeded", True,
                                            True),
    ("int8-blocks", "descent", True, True)])
def test_kernel_steps_give_the_plain_rows(host, layout, entry, fast_math,
                                          rerank):
    """The kernel's per-query steps give search_graph_reference's rows bit
    for bit (rerank ties in pool order included), and its per-layer hop
    counts are the largest of the queries' own."""
    _, tg, q = _graphs(host, layout)
    q = torch.from_numpy(q)
    seeds = torch.from_numpy(_seeds(len(q))) if entry == "seeded" else None
    kw = dict(k=8, ef=24, metric="sqeuclidean", max_hops=48, expand=2,
              merge="sort", fast_math=fast_math, device_rerank=rerank,
              ef_upper=0, seed_ids=seeds)
    md, mi, mh = _kernel_steps(tg, q, **kw)
    stats = {}
    rd, ri = tsearch.search_graph_reference(tg, q, stats=stats, **kw)
    np.testing.assert_array_equal(mi.numpy(), ri.numpy())
    np.testing.assert_array_equal(md.numpy(), rd.numpy())
    assert mh.max(axis=1).tolist() == stats["hops"]


def test_kernel_steps_rank_rerank_ties_in_pool_order(host):
    """Copies of rows tie exactly in the rerank: the rank by counting puts
    them in pool order, as the stable sort does."""
    _, tg, q = _graphs(host, "dense")
    q = torch.from_numpy(q)
    kw = dict(k=12, ef=32, metric="sqeuclidean", max_hops=48, expand=2,
              merge="sort", fast_math=True, device_rerank=True, ef_upper=0,
              seed_ids=None)
    md, mi, _ = _kernel_steps(tg, q, **kw)
    rd, ri = tsearch.search_graph_reference(tg, q, **kw)
    np.testing.assert_array_equal(mi.numpy(), ri.numpy())
    d = md.numpy()
    ties = sum(len(row) - len(np.unique(row)) for row in d)
    assert ties > 0


# --------------------------------------------------------------------------
# (c) the predicate, the counts, the one-copy read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_plan_routes_each_layout_as_layer_mode(host, layout, merge):
    _, tg, q = _graphs(host, layout)
    q = torch.from_numpy(q)
    for n_seed in (None, 6):
        plan, reason = gs._plan(tg, "sqeuclidean", 24, 8, 2, merge, n_seed)
        assert reason == "" and plan is not None
        assert plan["mode0"] == bs.layer_mode(tg, 0, "sqeuclidean", 24, 2,
                                              merge)
        n_up = tg.num_layers - 1 if n_seed is None else 0
        assert plan["n_up"] == n_up
        for layer in range(1, tg.num_layers):
            assert bs.layer_mode(tg, layer, "sqeuclidean", 8, 2, merge) \
                == plan["mode_up"] == gs.row_mode(tg)
        M0 = plan["M0"]
        want = bs.smem_bytes(tg.dim, 24, 2, M0, merge)
        if n_up:
            want = max(want, bs.smem_bytes(tg.dim, 8, 2, plan["M_up"],
                                           merge))
        want = ((want + 7) & ~7) + 8 * (1 if n_seed is None else 6)
        assert plan["smem"] == want
        # a CPU graph never takes the kernel
        assert not gs.search_kernel_applies(tg, "sqeuclidean", q, 24, 8, 2,
                                            merge, n_seed)


def test_plan_takes_the_larger_layer_and_refuses_past_the_limits(
        host, monkeypatch):
    _, tg, _ = _graphs(host, "dense")
    M = tg.layer_width(0)
    # the upper layers' pool can be the larger one
    plan, _ = gs._plan(tg, "l2", 16, 512, 4, "bitonic", None)
    assert plan["smem"] == ((bs.smem_bytes(tg.dim, 512, 4, tg.layer_width(1),
                                           "bitonic") + 7) & ~7) + 8
    big = bs.HOP_MAX_WIDTH - 4 * M
    assert gs._plan(tg, "l2", big, 8, 4, "sort", None)[0] is not None
    assert gs._plan(tg, "l2", big + 1, 8, 4, "sort", None) == (None, "size")
    assert gs._plan(tg, "l2", 16, bs.HOP_MAX_WIDTH, 4, "sort", None) == (
        None, "size")
    # the upper layers are not searched with seeds: their pool is free
    assert gs._plan(tg, "l2", 16, bs.HOP_MAX_WIDTH, 4, "sort", 4)[0] \
        is not None
    assert gs._plan(tg, "l2", 16, 8, 4, "sort", 0) == (None, "mode")
    assert gs._plan(tg, "l2", 16, 8, 4, "odd-even", None) == (None, "mode")
    register_distance("k5_manhattan", lambda a, b: torch.cdist(a, b, p=1.0))
    assert gs._plan(tg, "k5_manhattan", 16, 8, 4, "sort", None) == (
        None, "mode")
    monkeypatch.setattr(gs, "MAX_UP", tg.num_layers - 2)
    assert gs._plan(tg, "l2", 16, 8, 4, "sort", None) == (None, "size")
    assert gs._plan(tg, "l2", 16, 8, 4, "sort", 3)[0] is not None


def test_plain_on_cuda_is_counted_by_reason(host):
    _, tg, _ = _graphs(host, "compact")
    before = dict(gs.plain_on_cuda)
    assert gs.count_plain(tg, "l2", 16, 8, 4, "odd-even") == "mode"
    assert gs.count_plain(tg, "l2", bs.HOP_MAX_WIDTH, 8, 4, "sort") == "size"
    assert gs.count_plain(tg, "l2", 16, 8, 4, "sort", 6) == "other"
    assert {r: gs.plain_on_cuda[r] - before[r] for r in before} == {
        "mode": 1, "size": 1, "other": 1}
    with gs.plain():
        assert not gs.search_kernel_applies(tg, "l2", torch.zeros(1, 16), 16,
                                            8, 4, "sort")
        gs.plain_on_cuda["other"] += 5
    assert gs.plain_on_cuda["other"] - before["other"] == 1
    gs.plain_on_cuda.update(before)
    # with twin, K2's predicate says no too, and its counts come back
    real, k2_before = bs.hop_kernel_applies, dict(bs.twin_layers_on_cuda)
    with gs.plain(twin=True):
        assert bs.hop_kernel_applies is not real
        assert bs.hop_kernel_applies(tg, 0, "l2", torch.zeros(1, 16), 16, 4,
                                     "sort") is False
        gs.plain_on_cuda["size"] += 2
        bs.twin_layers_on_cuda["other"] += 3
    assert bs.hop_kernel_applies is real
    assert gs.plain_on_cuda == before
    assert bs.twin_layers_on_cuda == k2_before


def test_cpu_graph_never_loads_the_library(host, monkeypatch):
    def broken():
        raise RuntimeError("the CPU path loaded the kernel library")
    monkeypatch.setattr(bs, "_lib", None)
    monkeypatch.setattr(gs, "_lib", None)
    monkeypatch.setattr(bs, "build", broken)
    launches = gs.launches
    for layout in ("dense", "compact", "int8-blocks", "quantized"):
        _, tg, q = _graphs(host, layout)
        stats = {}
        d, i = tsearch.search_graph(tg, torch.from_numpy(q), k=8, ef=24,
                                    metric="sqeuclidean", stats=stats)
        assert i.shape == (16, 8) and "hops_by_query" not in stats
        dh, ih = tsearch.results_to_host(d, i, stats)
        np.testing.assert_array_equal(ih, i.numpy())
        assert len(stats["hops"]) == tg.num_layers
    assert gs.launches == launches and bs._lib is None and gs._lib is None


def test_results_come_back_in_one_copy_of_the_buffer():
    """The kernel's outputs are views of one int32 buffer (dists as float
    bits, ids, hops [layers, B]); to_host reads them back from one copy
    and results_to_host fills the per-layer maxima."""
    B, k, L = 5, 3, 4
    buf = torch.empty(2 * B * k + L * B, dtype=torch.int32)
    d = buf[:B * k].view(torch.float32).view(B, k)
    i = buf[B * k:2 * B * k].view(B, k)
    h = buf[2 * B * k:].view(L, B)
    d.copy_(torch.arange(B * k, dtype=torch.float32).view(B, k) / 7)
    i.copy_(torch.arange(B * k, dtype=torch.int32).view(B, k) - 2)
    h.copy_(torch.arange(L * B, dtype=torch.int32).view(L, B) % 6)
    for got, want in zip(gs.to_host(d, i, h), (d, i, h)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    stats = {"hops_by_query": h}
    dh, ih = tsearch.results_to_host(d, i, stats)
    np.testing.assert_array_equal(dh, d.numpy())
    np.testing.assert_array_equal(ih, i.numpy())
    assert stats["hops"] == h.amax(1).tolist()


def test_hop_maxima_can_be_left_to_the_caller():
    """With ``hops=False`` results_to_host leaves the hop counts on the
    host as [layers, B] and takes no maxima; ``hop_maxima`` takes them
    (zeros for an empty batch)."""
    h = (torch.arange(12, dtype=torch.int32).view(3, 4) * 7) % 5
    stats = {"hops_by_query": h}
    d = torch.zeros((4, 2))
    i = torch.zeros((4, 2), dtype=torch.int32)
    tsearch.results_to_host(d, i, stats, hops=False)
    assert "hops" not in stats
    assert torch.equal(stats["hops_by_query"], h)
    assert tsearch.hop_maxima(h) == h.amax(1).tolist()
    assert tsearch.hop_maxima(torch.zeros((2, 0), dtype=torch.int32)) \
        == [0, 0]


def test_graph_reduces_k5s_hop_counts_only_when_read(monkeypatch):
    """On K5's path the graph keeps the hop counts a query from the one
    copy and ``last_search_hops`` takes each layer's largest when read,
    not on every call (here K5 is stood in for by the plain version plus
    the counts it would leave)."""
    from hnsw_tpu_torch.index import hnsw as thnsw
    rng = np.random.default_rng(8)
    g = hnsw_tpu_torch.Graph(m=4, metric="l2", seed=0, device="cpu")
    g.build(list(range(300)), rng.standard_normal((300, 8))
            .astype(np.float32), method="host")
    g.native_serve_max_batch = 0
    counts = torch.tensor([[1, 4, 2], [3, 0, 9]], dtype=torch.int32)
    real = thnsw.search_graph

    def k5(g_, q, **kw):
        d, i = real(g_, q, **{**kw, "stats": None})
        kw["stats"]["hops_by_query"] = counts
        return d, i

    reduced = []
    real_max = thnsw.hop_maxima
    monkeypatch.setattr(thnsw, "search_graph", k5)
    monkeypatch.setattr(thnsw, "hop_maxima",
                        lambda h: reduced.append(1) or real_max(h))
    for _ in range(3):
        g.batch_search_slots(rng.standard_normal((3, 8)).astype(np.float32),
                             2)
    assert reduced == []
    assert g.last_search_hops == [4, 9] and reduced == [1]
    monkeypatch.setattr(thnsw, "search_graph", real)
    g.batch_search_slots(rng.standard_normal((3, 8)).astype(np.float32), 2)
    assert len(g.last_search_hops) == g.device_graph().num_layers


class _FakeLib:
    """Stands in for the library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def graph_search_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_wrapper_hands_the_launch_its_outputs_and_counts_it_once(
        host, monkeypatch, merge):
    """graph_search_cuda makes one launch with every argument the library
    declares (``_load``: 19, then 20 ints, then four pointers), the merge
    and the three outputs in their places, and counts it once (the
    library and the card stood in for; the queries carry is_cuda)."""
    import contextlib

    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    _, tg, q = _graphs(host, "dense")
    lib = _FakeLib()
    monkeypatch.setattr(gs, "_load", lambda: lib)
    monkeypatch.setattr(gs.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(gs.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    plan, _ = gs._plan(tg, "sqeuclidean", 24, 8, 2, merge, None)
    before = (gs.launches, dict(gs.launches_by_mode))
    d, i, h = gs.graph_search_cuda(
        tg, torch.from_numpy(q).as_subclass(Cuda), plan, k=8, P0=24,
        P_up=8, expand=2, max_hops=16, metric="sqeuclidean",
        precision=HIGHEST, merge=merge, store_normalized=False,
        rerank=False)
    assert d.shape == (16, 8) and h.shape == (tg.num_layers, 16)
    (args,) = lib.calls
    assert len(args) == 19 + 20 + 4
    # ..., merge, normalized, round_up, round_0, out_d, out_i, hops, stream
    assert args[-8] == bs._MERGE_CODE[merge]
    assert args[-4] == d.data_ptr() and args[-3] == i.data_ptr()
    assert args[-2] == h.data_ptr()
    assert gs.launches == before[0] + 1
    assert {m: gs.launches_by_mode[m] - before[1][m] for m in bs.MODES} \
        == {m: int(m == "rows") for m in bs.MODES}
    gs.launches = before[0]
    gs.launches_by_mode.update(before[1])


def test_only_k2_asks_l2_for_rows_ahead():
    """In a row store the builder's K2 asks the L2 cache for each gathered
    id's row as the id arrives; K5 asks for none (csrc/beam_search.cu:
    layer_search's PREFETCH, true in beam_search_kernel, false in every
    layer of graph_search_kernel). A block layout asks for its slot's row
    in both."""
    import re
    with open(bs.SOURCE) as f:
        src = f.read()
    k2 = src[src.index("beam_search_kernel(Params a)"):
             src.index("// ---- K5: every layer")]
    k5 = src[src.index("graph_search_kernel(GraphParams g)"):]
    assert re.findall(r"layer_search<[^>]*>", k2) == [
        "layer_search<SCORE, VEC, true>"]
    assert sorted(re.findall(r"layer_search<[^>]*>", k5)) == [
        "layer_search<SCORE0, VEC, false>",
        "layer_search<SCOREUP, VEC, false>"]
    body = src[src.index("int layer_search("):src.index("// ---- K2:")]
    conds = re.findall(r"if \(([^)]*)\)\s*prefetch_l2\(", body)
    assert conds == ["BLOCKS", "!BLOCKS && PREFETCH"]
