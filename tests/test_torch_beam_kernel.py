"""The graph tier's beam-search kernel (K2) and its plain twin.

``core/search.beam_search_layer`` runs one layer through the CUDA kernel
(``ops/beam_search``, one block a query) where
``ops/beam_search.hop_kernel_applies``, else through
``beam_search_layer_reference``, the twin. The graphs are
tests/test_torch_search.py's: 2,500 natively built nodes with every 50th
deleted, cosine and l2, m = 8, D = 32.

On the CPU:
  (a) the kernel's premise: the twin run on each query alone gives the
      pool it gives on the whole batch, and the batch's hop count is the
      largest single-query count (a query that stops keeps its pool);
  (b) the twin against ``hnsw_tpu.core.search.beam_search_layer``, on
      f32 rows and on the capacity stores (the JAX Graph's int8 capacity
      mode, fp16 store and bf16 store, carried across), with JAX pinned
      to its CPU backend in this module; the int8 rows' scores against
      their float64 product with the bf16-rounded query;
  (c) which calls the predicate sends to the kernel, from each layout's
      tensors (every layout from_host makes has a mode), and that a CPU
      graph never loads the library.
Marked ``cuda`` (skipped without an NVIDIA GPU; decided in the fixture):
  (d) the kernel against the twin on the same layer inputs, in every mode
      it covers (f32 rows, int8 / fp16 blocks, the capacity stores' int8
      rows with per-row scales, fp16 and bf16 rows), and where its design
      could part from the twin's: equal distances, a hop's duplicate ids,
      an INF start entry with a valid id, scalar loads (D = 7, a view off
      alignment), the widest pool, a whole batch of 1,024 queries in one
      wave, a query whose bf16 rounding shows in its distances. Ids
      overlap >= 0.99; distances of shared ids within 1e-5 (every product
      is exact in f32 or rounded once on either side, so only the order
      of f32 sums differs), but 1e-3 on int8 blocks (their squared norms
      are f32 sums rounded to bf16); hop counts equal. Run on a GPU
      machine with
      ``python3 -m pytest --noconftest tests/test_torch_beam_kernel.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core.state import DeviceGraph, from_host  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.ops.distance import (DEFAULT, HIGHEST,  # noqa: E402
                                         INF_DIST, register_distance)

INF = float(INF_DIST)
#: the kernel's layouts: from_host keyword arguments
LAYOUTS = {"dense": {}, "split": dict(split_layers=True, upper_m=8),
           "compact": dict(split_layers="compact", upper_m=8),
           "int8-blocks": dict(block_layout=True, block_dtype="int8"),
           "fp16-blocks": dict(block_layout=True, block_dtype="float16")}


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _host_graph(metric, d=32):
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, metric=metric, seed=3,
                             device="cpu")
    v = _data(1, 2500, d)
    g.build(list(range(len(v))), v, method="host")
    g.batch_delete(list(range(0, 2500, 50)))      # tombstones
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    return (g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
            levels[:n], g.store.alive[:n], entry)


@pytest.fixture(scope="module")
def hosts():
    """Host arrays of the seeded graph per metric (l2 also serves
    sqeuclidean and dot: the kernel's metric is an argument)."""
    return {m: _host_graph(m) for m in ("cosine", "l2")}


def _layout(hosts, metric, layout="dense", device="cpu", **kw):
    arrays = hosts["cosine" if metric == "cosine" else "l2"]
    return from_host(*arrays, metric=metric, device=device,
                     **{**LAYOUTS[layout], **kw})


def _starts(g, q, q_sq, metric, precision, seeded, seed=0):
    """Start entries [B, S]: the graph's entry, or S = 6 seeded slots with
    a repeated id, a -1 and a valid id at INF (as the builder's refine
    seeds the node itself)."""
    B = q.shape[0]
    if not seeded:
        ids = g.entry.expand(B).to(torch.int32)[:, None]
    else:
        r = np.random.default_rng(seed)
        ids = torch.from_numpy(
            r.integers(0, 2400, (B, 6)).astype(np.int32)).to(q.device)
        ids[:, 1] = ids[:, 0]
        ids[:, 2] = -1
    safe = torch.clamp(ids, 0, g.cap - 1)
    d = tsearch._score_hop(g, q, q_sq, safe, metric, precision)
    d = torch.where(ids >= 0, d, INF)
    if seeded:
        d[:, 3] = INF
    return ids, d


def _jax_on_the_cpu():
    """JAX pinned to its CPU backend before it first runs, as
    tests/conftest.py pins it, also where the conftest is skipped (the
    card's runs of this file use --noconftest). The comparisons below hold
    the twin to the JAX package's contract as its CPU build computes it:
    on the card, an XLA GPU build of the int8-row scoring keeps the query
    in f32 (its default excess precision drops the bf16 rounding that
    ``_score_hop`` asks for), whatever the matmul precision."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    return jax


def _queries(device="cpu", n=24, d=32, seed=2):
    q = torch.from_numpy(_data(seed, n, d)).to(device)
    return q, torch.sum(q * q, dim=-1)


# --------------------------------------------------------------------------
# (a) the premise: one query alone == the batch, hops = the largest count
# --------------------------------------------------------------------------

@pytest.mark.parametrize("start,max_hops", [("entry", 64), ("seeded", 64),
                                            ("entry", 3)])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_single_query_equals_batch(hosts, merge, expand, start, max_hops):
    metric = "cosine" if merge == "bitonic" else "l2"
    precision = HIGHEST if expand == 1 else DEFAULT
    g = _layout(hosts, metric)
    q, q_sq = _queries()
    ids, d = _starts(g, q, q_sq, metric, precision, start == "seeded")
    kw = dict(pool_size=24, max_hops=max_hops, metric=metric,
              precision=precision, expand=expand, merge=merge,
              store_normalized=metric == "cosine")
    stats = {}
    bd, bi = tsearch.beam_search_layer_reference(g, 0, q, q_sq, ids, d,
                                                 stats=stats, **kw)
    single_hops = []
    for b in range(q.shape[0]):
        st = {}
        sd, si = tsearch.beam_search_layer_reference(
            g, 0, q[b:b + 1], q_sq[b:b + 1], ids[b:b + 1], d[b:b + 1],
            stats=st, **kw)
        np.testing.assert_array_equal(si.numpy()[0], bi.numpy()[b])
        np.testing.assert_array_equal(sd.numpy()[0], bd.numpy()[b])
        single_hops.append(st["hops"][0])
    assert stats["hops"] == [max(single_hops)]
    assert 0 < max(single_hops) <= max_hops
    if max_hops == 3:
        assert max(single_hops) == 3           # the cut binds


# --------------------------------------------------------------------------
# (b) the twin against the JAX package's beam_search_layer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_graphs():
    """(jax DeviceGraph, port DeviceGraph) per metric, laid out by the JAX
    package and carried into the port, as tests/test_torch_search.py."""
    _jax_on_the_cpu()
    import hnsw_tpu
    from hnsw_tpu_torch.convert import device_graph_from_numpy
    out = {}
    for metric in ("cosine", "l2"):
        g = hnsw_tpu.Graph(m=8, ef_construction=64, metric=metric, seed=3)
        v = _data(1, 2500)
        g.build(list(range(len(v))), v, method="host")
        g.batch_delete(list(range(0, 2500, 50)))
        dev = g.device_graph()
        fields = {k: np.asarray(x) for k, x in dev._asdict().items()
                  if x is not None}
        out[metric] = (dev, device_graph_from_numpy(fields, "cpu"))
    return out


@pytest.mark.parametrize("layer", [0, "top"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_twin_matches_jax_layer(jax_graphs, metric, merge, expand, layer):
    jax = _jax_on_the_cpu()
    import jax.numpy as jnp
    from hnsw_tpu.core import search as jsearch
    jg, tg = jax_graphs[metric]
    layer = tg.num_layers - 1 if layer == "top" else 0
    q, q_sq = _queries()
    ids, d = _starts(tg, q, q_sq, metric, HIGHEST, False)
    P = 32 if layer == 0 else 8
    jd, ji = jsearch.beam_search_layer(
        jg, layer, jnp.asarray(q.numpy()), jnp.asarray(q_sq.numpy()),
        jnp.asarray(ids.numpy()), jnp.asarray(d.numpy()), P, 64, metric,
        jax.lax.Precision.HIGHEST, expand=expand, merge=merge)
    td, ti = tsearch.beam_search_layer_reference(
        tg, layer, q, q_sq, ids, d, P, 64, metric, HIGHEST, expand=expand,
        merge=merge)
    ov, err = _overlap_and_err(np.asarray(jd), np.asarray(ji), td.numpy(),
                               ti.numpy())
    assert ov >= 0.99 and err <= 1e-5, (ov, err)


#: the capacity stores of the JAX Graph: the attributes set before
#: device_graph() (``store_dtype`` through the config)
CAPACITY_STORES = {"quantized": dict(hbm_mode="quantized"),
                   "float16": dict(hbm_mode="float16"),
                   "bfloat16": dict(store_dtype="bfloat16")}


@pytest.fixture(scope="module")
def jax_capacity_graphs():
    """(jax DeviceGraph, port DeviceGraph) per (store, metric): the JAX
    Graphs of ``jax_graphs``' seeded build laid out by the JAX package in
    each capacity store (the int8 capacity mode's qvec rows with per-row
    scales and a [1, D] placeholder; an fp16 store; a bf16 store, carried
    across bit for bit) and carried into the port."""
    import dataclasses
    _jax_on_the_cpu()
    import hnsw_tpu
    from hnsw_tpu_torch.convert import device_graph_from_numpy
    out = {}
    for metric in ("cosine", "l2"):
        g = hnsw_tpu.Graph(m=8, ef_construction=64, metric=metric, seed=3)
        v = _data(1, 2500)
        g.build(list(range(len(v))), v, method="host")
        g.batch_delete(list(range(0, 2500, 50)))
        for store, attrs in CAPACITY_STORES.items():
            cfg, mode = g.cfg, g.hbm_mode
            if "store_dtype" in attrs:
                g.cfg = dataclasses.replace(cfg,
                                            store_dtype=attrs["store_dtype"])
            g.hbm_mode = attrs.get("hbm_mode", "full")
            g._dirty = True
            dev = g.device_graph()
            fields = {k: np.asarray(x) for k, x in dev._asdict().items()
                      if x is not None}
            out[store, metric] = (dev, device_graph_from_numpy(fields,
                                                               "cpu"))
            g.cfg, g.hbm_mode, g._dirty = cfg, mode, True
    return out


#: the twin against JAX on the capacity stores: the largest matched
#: distance gap. The fp16 and bf16 stores multiply an f32 query at
#: HIGHEST on both sides; the int8 rows take a bf16-rounded query against
#: the exact upcast (every product exact in f32), so each side differs
#: only in its order of f32 sums. fp16: 1e-5, as the f32 rows; int8 and
#: bf16: 1e-6, the measured bound (1.2e-7 in every case, ids equal).
CAPACITY_TOL = {"quantized": 1e-6, "float16": 1e-5, "bfloat16": 1e-6}


@pytest.mark.parametrize("layer", [0, "top"])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("store", list(CAPACITY_STORES))
def test_twin_matches_jax_layer_on_capacity_stores(jax_capacity_graphs,
                                                   store, metric, merge,
                                                   layer):
    """The twin's capacity-store scoring (the rows K2's qrows / f16rows /
    bf16rows modes reproduce) against hnsw_tpu.core.search's
    beam_search_layer on the same layer inputs."""
    jax = _jax_on_the_cpu()
    import jax.numpy as jnp
    from hnsw_tpu.core import search as jsearch
    jg, tg = jax_capacity_graphs[store, metric]
    mode = {"quantized": "qrows", "float16": "f16rows",
            "bfloat16": "bf16rows"}[store]
    layer = tg.num_layers - 1 if layer == "top" else 0
    P = 32 if layer == 0 else 8
    assert bs.layer_mode(tg, layer, metric, P, 4, merge) == mode
    q, q_sq = _queries()
    ids, d = _starts(tg, q, q_sq, metric, HIGHEST, False)
    jd, ji = jsearch.beam_search_layer(
        jg, layer, jnp.asarray(q.numpy()), jnp.asarray(q_sq.numpy()),
        jnp.asarray(ids.numpy()), jnp.asarray(d.numpy()), P, 64, metric,
        jax.lax.Precision.HIGHEST, expand=4, merge=merge,
        store_normalized=metric == "cosine")
    td, ti = tsearch.beam_search_layer_reference(
        tg, layer, q, q_sq, ids, d, P, 64, metric, HIGHEST, expand=4,
        merge=merge, store_normalized=metric == "cosine")
    ov, err = _overlap_and_err(np.asarray(jd), np.asarray(ji), td.numpy(),
                               ti.numpy())
    assert ov >= 0.999 and err <= CAPACITY_TOL[store], (ov, err)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_int8_row_scores_use_the_bf16_rounded_query(jax_capacity_graphs,
                                                     metric):
    """The int8 capacity mode's row scores (what K2's qrows mode and the
    twin compute) are the bf16-rounded query times the exact int8 rows,
    summed in f32, times the row's scale: the twin's ``_score_hop`` and
    hnsw_tpu's on JAX's CPU backend both equal that product in float64,
    while the product with the unrounded f32 query lies farther off. That
    gap is what the JAX comparisons above see when JAX runs on an XLA GPU
    build, which keeps the query in f32."""
    jax = _jax_on_the_cpu()
    import jax.numpy as jnp
    from hnsw_tpu.core import search as jsearch
    from hnsw_tpu_torch.ops.distance import bf16_round
    jg, tg = jax_capacity_graphs["quantized", metric]
    q, q_sq = _queries()
    rows_in = torch.nonzero(tg.qvec.abs().sum(1) > 0).flatten()
    nb = rows_in[torch.from_numpy(np.random.default_rng(5).integers(
        0, len(rows_in), (q.shape[0], 24)))]
    td = tsearch._score_hop(tg, q, q_sq, nb, "dot", HIGHEST).double()
    jd = torch.from_numpy(np.asarray(jsearch._score_hop(
        jg, jnp.asarray(q.numpy()), jnp.asarray(q_sq.numpy()),
        jnp.asarray(nb.numpy()), "dot", jax.lax.Precision.HIGHEST),
        dtype=np.float64))
    rows = tg.qvec[nb].double() * tg.qscale[nb].double()[..., None]
    want = -torch.einsum("bd,bcd->bc", bf16_round(q).double(), rows)
    unrounded = -torch.einsum("bd,bcd->bc", q.double(), rows)
    scale = torch.einsum("bd,bcd->bc", q.double().abs(), rows.abs())
    assert ((td - want).abs() / scale).max() <= 1e-6
    assert ((jd - want).abs() / scale).max() <= 1e-6
    assert ((unrounded - want).abs() / scale).max() > 1e-4


def _overlap_and_err(da, ia, db, ib):
    """Share of ``ib``'s valid ids found in ``ia`` (row by row) and the
    largest distance gap over the ids both hold."""
    hits, err = 0, 0.0
    for rda, ria, rdb, rib in zip(da, ia, db, ib):
        pos = {int(x): p for p, x in enumerate(ria) if x >= 0}
        for p, x in enumerate(rib):
            if x >= 0 and int(x) in pos:
                hits += 1
                err = max(err, abs(float(rda[pos[int(x)]]) - float(rdb[p])))
    return hits / max(1, int((ib >= 0).sum())), err


# --------------------------------------------------------------------------
# (c) the predicate, from each layout's tensors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout,store,want0,want_up", [
    ("dense", {}, "rows", "rows"),
    ("split", {}, "rows", "rows"),
    ("compact", {}, "rows", "rows"),
    ("int8-blocks", {}, "blocks", "rows"),
    ("fp16-blocks", {}, "blocks", "rows"),
    ("int8-blocks", dict(hbm_vectors=False), "blocks", "qrows"),
    ("dense", dict(quantize=True, hbm_vectors=False), "qrows", "qrows"),
    ("dense", dict(store_dtype="float16"), "f16rows", "f16rows"),
    ("dense", dict(store_dtype="bfloat16"), "bf16rows", "bf16rows"),
    ("fp16-blocks", dict(store_dtype="float16"), "blocks", "f16rows"),
    ("compact", dict(quantize=True, hbm_vectors=False), "qrows", "qrows"),
    ("split", dict(store_dtype="float16"), "f16rows", "f16rows"),
    ("compact", dict(store_dtype="bfloat16"), "bf16rows", "bf16rows"),
    ("fp16-blocks", dict(hbm_vectors=False), "blocks", "qrows"),
    ("dense", dict(quantize=True), "rows", "rows")])
def test_layer_mode_routes_each_layout(hosts, layout, store, want0,
                                       want_up):
    """Every layer of every layout from_host makes has a kernel mode (the
    twin's _score_hop order: layer-0 blocks, the int8 capacity mode's
    rows, then the store by its dtype); on the CPU none takes the
    kernel."""
    g = _layout(hosts, "cosine", layout, **store)
    assert bs.layer_mode(g, 0, "cosine", 64, 4) == want0
    for layer in range(1, g.num_layers):
        assert bs.layer_mode(g, layer, "cosine", 8, 4) == want_up
    q, _ = _queries()
    assert not bs.hop_kernel_applies(g, 0, "cosine", q, 64, 4)


@pytest.mark.parametrize("precision", [HIGHEST, DEFAULT])
@pytest.mark.parametrize("layout,store", [
    ("dense", None), ("int8-blocks", None), ("fp16-blocks", None),
    ("dense", "quantized"), ("dense", "float16"), ("dense", "bfloat16")])
def test_rounds_operands_says_what_the_twin_does(hosts, layout, store,
                                                 precision):
    """rounds_operands, which tells the kernel whether to round the query
    to bf16, against the twin's layer-0 scoring on the CPU: the twin gives
    the same distances, bit for bit, for the query and for its bf16
    rounding exactly where rounds_operands says the query is rounded."""
    from hnsw_tpu_torch.ops.distance import bf16_round
    g = _layout(hosts, "l2", layout, **(STORES[store][0] if store else {}))
    mode = bs.layer_mode(g, 0, "l2", 32, 4)
    q, q_sq = _queries()
    qr = bf16_round(q)
    assert not torch.equal(q, qr)
    if mode == "blocks":
        cur = torch.arange(4 * len(q), dtype=torch.int32).reshape(-1, 4)
        a, b = (tsearch._score_blocks(g, x, q_sq, cur, "l2", False)
                for x in (q, qr))
    else:
        nb = torch.clamp(g.neighbors[0][:len(q)], 0)
        a, b = (tsearch._score_hop(g, x, q_sq, nb, "l2", precision)
                for x in (q, qr))
    rounds = bs.rounds_operands(bs.score_code(g, mode, precision),
                                precision)
    assert torch.equal(a, b) == rounds, (mode, precision)


def test_layer_mode_limits_and_metrics():
    """P + E*M <= 4,096 within 227 KB: ef 512 at E = 4, M0 = 32 fits, the
    next pool past the width does not; registered metrics and unknown
    merges run the twin. The tensors lie on "meta": shapes and types are
    all the predicate reads, and a meta tensor is not a CUDA tensor."""
    meta = torch.device("meta")
    g = DeviceGraph(
        vectors=torch.empty((4096, 128), device=meta),
        sq_norms=torch.empty(4096, device=meta),
        neighbors=torch.empty((1, 4096, 32), dtype=torch.int32, device=meta),
        levels=torch.empty(4096, dtype=torch.int32, device=meta),
        alive=torch.empty(4096, dtype=torch.bool, device=meta),
        entry=torch.empty((), dtype=torch.int32, device=meta))
    for merge in ("bitonic", "sort"):
        assert bs.layer_mode(g, 0, "l2", 512, 4, merge) == "rows"
        assert bs.layer_mode(g, 0, "l2", 4096 - 128, 4, merge) == "rows"
        assert bs.layer_mode(g, 0, "l2", 4096 - 127, 4, merge) is None
    assert bs.smem_bytes(128, 512, 4, 32, "bitonic") == 32_304
    assert bs.smem_bytes(128, 4096 - 128, 4, 32, "bitonic") <= bs.SMEM_LIMIT
    for metric in ("cosine", "l2", "sqeuclidean", "dot"):
        assert bs.layer_mode(g, 0, metric, 64, 4) == "rows"
    register_distance("beam_kernel_test_l1",
                      lambda a, b: float(np.abs(a - b).sum()),
                      pairwise_fn=lambda a, b: torch.cdist(a, b, p=1))
    assert bs.layer_mode(g, 0, "beam_kernel_test_l1", 64, 4) is None
    assert bs.layer_mode(g, 0, "l2", 64, 4, "heap") is None
    q = torch.empty((8, 128), device=meta)
    assert not bs.hop_kernel_applies(g, 0, "l2", q, 64, 4)


def _earlier_smem_bytes(D, P, E, M, merge):
    """The shared memory of the kernel's earlier layout (the query row,
    pool, merge buffer, six candidate arrays, no hash table or sort
    keys), for the coverage check below."""
    C = E * M
    wb = P if merge == "sort" else 1 << (P + C - 1).bit_length()
    return 4 * (((D + 3) & ~3) + 2 * P + 2 * wb + 6 * C + 2 * E + 4)


@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_smem_bytes_at_the_limits(merge):
    """The layout's bytes (csrc/beam_search.cu's note): the table and keys
    at 8 bytes a slot, the rest at 4. ef 64 / 192 at the smoke's D = 128,
    E = 4, M = 32 stay under 27.5 KB (eight blocks an SM); ef 512 and
    P + E*M = 4,096 fit 227 KB."""
    want = {"bitonic": {64: 10_288, 192: 17_456, 512: 32_304,
                        3968: 133_680},
            "sort": {64: 7_216, 192: 12_336, 512: 21_552, 3968: 134_192}}
    for P, nbytes in want[merge].items():
        assert bs.smem_bytes(128, P, 4, 32, merge) == nbytes
        for D in (7, 960, 4096):     # the query row: D padded to 4, 4 bytes
            assert bs.smem_bytes(D, P, 4, 32, merge) \
                == nbytes + 4 * (((D + 3) & ~3) - 128)
    assert bs.smem_bytes(128, 192, 4, 32, merge) <= 28_160   # 27.5 KB
    assert bs.smem_bytes(128, 4096 - 128, 4, 32, merge) <= bs.SMEM_LIMIT
    assert bs.smem_bytes(128, 4096 - 8, 1, 8, merge) <= bs.SMEM_LIMIT


@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_layer_mode_keeps_every_shape_it_took(merge):
    """Every (D, P, E, M) that the earlier layout fitted in 227 KB within
    P + E*M <= 4,096 the kernel still takes, for D up to 16,384. (The hash
    table and sort keys cost up to 64 KB more at the width limit, so there
    D may now reach 24,692 where it reached 41,204.)"""
    meta = torch.device("meta")
    for D in (7, 32, 128, 960, 4096, 16_384):
        for M in (8, 16, 32, 64):
            g = DeviceGraph(
                vectors=torch.empty((8, D), device=meta),
                sq_norms=torch.empty(8, device=meta),
                neighbors=torch.empty((1, 8, M), dtype=torch.int32,
                                      device=meta),
                levels=torch.empty(8, dtype=torch.int32, device=meta),
                alive=torch.empty(8, dtype=torch.bool, device=meta),
                entry=torch.empty((), dtype=torch.int32, device=meta))
            for E in (1, 4, 8):
                for P in (8, 64, 100, 192, 512, 1024, 4096 - E * M):
                    if P < 1 or P + E * M > bs.HOP_MAX_WIDTH:
                        continue
                    old = _earlier_smem_bytes(D, P, E, M, merge)
                    if old <= bs.SMEM_LIMIT:
                        assert bs.layer_mode(g, 0, "l2", P, E, merge) \
                            == "rows", (D, P, E, M)
                        assert bs.smem_bytes(D, P, E, M, merge) \
                            <= bs.SMEM_LIMIT


def test_twin_layers_on_cuda_are_counted_by_reason(hosts, monkeypatch):
    """count_twin_layer: a covered mode past the width limit is "size" (the
    capacity stores included), a mode the kernel lacks (only a registered
    metric) is "mode", a covered mode within its limits (a graph not on
    the card, the twin forced) is "other"; the dispatcher counts only
    layers on CUDA tensors, so a CPU search counts none."""
    meta = torch.device("meta")
    g = DeviceGraph(
        vectors=torch.empty((4096, 128), device=meta),
        sq_norms=torch.empty(4096, device=meta),
        neighbors=torch.empty((1, 4096, 32), dtype=torch.int32, device=meta),
        levels=torch.empty(4096, dtype=torch.int32, device=meta),
        alive=torch.empty(4096, dtype=torch.bool, device=meta),
        entry=torch.empty((), dtype=torch.int32, device=meta))
    monkeypatch.setattr(bs, "twin_layers_on_cuda",
                        {"mode": 0, "size": 0, "other": 0})
    assert bs.count_twin_layer(g, 0, "l2", 4096 - 127, 4, "sort") == "size"
    register_distance("beam_kernel_test_l1",
                      lambda a, b: float(np.abs(a - b).sum()),
                      pairwise_fn=lambda a, b: torch.cdist(a, b, p=1))
    assert bs.count_twin_layer(g, 0, "beam_kernel_test_l1", 64, 4) == "mode"
    fp16 = _layout(hosts, "cosine", store_dtype="float16")
    P = bs.HOP_MAX_WIDTH - 4 * fp16.layer_width(0)
    assert bs.count_twin_layer(fp16, 0, "cosine", P + 1, 4) == "size"
    assert bs.count_twin_layer(fp16, 0, "cosine", P, 4) == "other"
    assert bs.count_twin_layer(fp16, 0, "cosine", 64, 4) == "other"
    assert bs.count_twin_layer(fp16, 0, "beam_kernel_test_l1", 64,
                               4) == "mode"
    assert bs.twin_layers_on_cuda == {"mode": 2, "size": 2, "other": 2}
    q, _ = _queries()
    tsearch.search_graph(fp16, q, k=10, ef=32, metric="cosine", expand=4,
                         merge="bitonic")
    assert bs.twin_layers_on_cuda == {"mode": 2, "size": 2, "other": 2}


@pytest.mark.parametrize("layout", ["dense", "int8-blocks"])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_touched_lists_what_each_hop_reads(hosts, layout, merge):
    """The twin's ``touched`` ids leave its pools as they are: one tensor a
    hop of the nodes it expanded (at most E a query) and of the rows it
    scored: vector slots, or node * block_m + j for block rows, each of a
    node expanded in that hop."""
    g = _layout(hosts, "cosine", layout)
    q, q_sq = _queries()
    ids, d = _starts(g, q, q_sq, "cosine", HIGHEST, True)
    kw = dict(pool_size=24, max_hops=64, metric="cosine", precision=HIGHEST,
              expand=4, merge=merge)
    stats, touched = {}, {}
    pd, pi = tsearch.beam_search_layer_reference(g, 0, q, q_sq, ids, d,
                                                 stats=stats,
                                                 touched=touched, **kw)
    rd, ri = tsearch.beam_search_layer_reference(g, 0, q, q_sq, ids, d, **kw)
    np.testing.assert_array_equal(pi.numpy(), ri.numpy())
    np.testing.assert_array_equal(pd.numpy(), rd.numpy())
    assert len(touched["nodes"]) == len(touched["rows"]) == stats["hops"][0]
    bm = g.nbr_blocks.shape[1] if layout == "int8-blocks" else None
    for nodes, rows in zip(touched["nodes"], touched["rows"]):
        assert 0 < nodes.numel() <= 4 * q.shape[0]
        assert (nodes >= 0).all() and (nodes < g.cap).all()
        assert rows.numel() > 0 and (rows >= 0).all()
        owner = rows // bm if bm else None
        if bm:
            assert set(owner.tolist()) <= set(nodes.tolist())
        else:
            assert (rows < g.cap).all()


def test_cpu_graph_never_loads_the_library(hosts, monkeypatch):
    def broken():
        raise RuntimeError("the CPU path loaded the kernel library")
    monkeypatch.setattr(bs, "_lib", None)
    monkeypatch.setattr(bs, "build", broken)
    launches = bs.launches
    q, _ = _queries()
    for layout in ("dense", "compact", "int8-blocks"):
        g = _layout(hosts, "cosine", layout)
        stats = {}
        d, i = tsearch.search_graph(g, q, k=10, ef=32, metric="cosine",
                                    expand=4, merge="bitonic", stats=stats)
        assert i.shape == (24, 10) and (i >= 0).all()
        assert len(stats["hops"]) == g.num_layers
    assert bs.launches == launches and bs._lib is None


def test_beam_search_layer_is_the_twin_on_the_cpu(hosts):
    """Off CUDA the dispatcher returns the twin's pools and hop count."""
    g = _layout(hosts, "l2", "compact")
    q, q_sq = _queries()
    ids, d = _starts(g, q, q_sq, "l2", HIGHEST, False)
    for layer in (0, g.num_layers - 1):
        a, b = {}, {}
        kw = dict(pool_size=16, max_hops=64, metric="l2",
                  precision=HIGHEST, expand=4, merge="sort")
        pd, pi = tsearch.beam_search_layer(g, layer, q, q_sq, ids, d,
                                           stats=a, **kw)
        rd, ri = tsearch.beam_search_layer_reference(g, layer, q, q_sq, ids,
                                                     d, stats=b, **kw)
        np.testing.assert_array_equal(pi.numpy(), ri.numpy())
        np.testing.assert_array_equal(pd.numpy(), rd.numpy())
        assert a == b


# --------------------------------------------------------------------------
# (d) the kernel against the twin, on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _reset():
    bs.launches = 0
    bs.launches_by_mode.update(dict.fromkeys(bs.MODES, 0))
    bs.twin_layers_on_cuda.update(mode=0, size=0, other=0)


#: the capacity stores: from_host keyword arguments, the kernel's mode
STORES = {"quantized": (dict(quantize=True, hbm_vectors=False), "qrows"),
          "float16": (dict(store_dtype="float16"), "f16rows"),
          "bfloat16": (dict(store_dtype="bfloat16"), "bf16rows")}


def _kernel_vs_twin(g, layer, q, q_sq, ids, d, *, P, E, metric, precision,
                    merge, max_hops=64, tol=1e-5, normalized=False):
    kw = dict(pool_size=P, max_hops=max_hops, metric=metric,
              precision=precision, expand=E, merge=merge,
              store_normalized=normalized)
    mode = bs.layer_mode(g, layer, metric, P, min(E, P), merge)
    assert mode is not None and bs.hop_kernel_applies(
        g, layer, metric, q, P, min(E, P), merge)
    _reset()
    ks, ts = {}, {}
    kd, ki = tsearch.beam_search_layer(g, layer, q, q_sq, ids, d, stats=ks,
                                       **kw)
    torch.cuda.synchronize()
    assert bs.launches == 1 and bs.launches_by_mode[mode] == 1
    rd, ri = tsearch.beam_search_layer_reference(g, layer, q, q_sq, ids, d,
                                                 stats=ts, **kw)
    kd, ki, rd, ri = (t.cpu().numpy() for t in (kd, ki, rd, ri))
    assert ki.shape == ri.shape == (q.shape[0], P)
    assert np.isfinite(kd).all()
    assert ((ki < 0) == (kd >= INF)).all()
    ov, err = _overlap_and_err(kd, ki, rd, ri)
    assert ov >= 0.99 and err <= tol, (ov, err)
    assert ks["hops"] == ts["hops"], (ks, ts)
    return ks["hops"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("precision", [HIGHEST, DEFAULT])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_kernel_matches_twin_on_rows(cuda, hosts, metric, merge, precision,
                                     expand):
    g = _layout(hosts, metric, device=cuda)
    q, q_sq = _queries(cuda, n=64)
    for layer in range(g.num_layers - 1, -1, -1):
        ids, d = _starts(g, q, q_sq, metric, precision, False)
        _kernel_vs_twin(g, layer, q, q_sq, ids, d, P=48 if layer == 0
                        else 8, E=expand, metric=metric,
                        precision=precision, merge=merge)


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("layout", ["int8-blocks", "fp16-blocks"])
def test_kernel_matches_twin_on_blocks(cuda, hosts, layout, metric, merge,
                                       expand):
    normalized = metric == "cosine"
    g = _layout(hosts, metric, layout, device=cuda)
    q, q_sq = _queries(cuda, n=64)
    ids, d = _starts(g, q, q_sq, metric, HIGHEST, True)
    _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=48, E=expand, metric=metric,
                    precision=DEFAULT, merge=merge,
                    tol=1e-3 if layout == "int8-blocks" else 1e-5,
                    normalized=normalized)


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("store,precision", [
    ("quantized", DEFAULT), ("float16", DEFAULT), ("bfloat16", HIGHEST),
    ("bfloat16", DEFAULT)])
def test_kernel_matches_twin_on_capacity_rows(cuda, hosts, store,
                                              precision, metric, merge,
                                              expand):
    """Every layer of the capacity stores, each one launch in its mode:
    the int8 rows take a bf16-rounded query and the row's own scale, the
    fp16 rows an f32 query even at DEFAULT (fast_math), the bf16 rows a
    query rounded at DEFAULT only."""
    kw, mode = STORES[store]
    g = _layout(hosts, metric, device=cuda, **kw)
    q, q_sq = _queries(cuda, n=64)
    for layer in range(g.num_layers - 1, -1, -1):
        assert bs.layer_mode(g, layer, metric, 8, expand) == mode
        ids, d = _starts(g, q, q_sq, metric, precision, layer == 0)
        _kernel_vs_twin(g, layer, q, q_sq, ids, d, P=48 if layer == 0
                        else 8, E=expand, metric=metric,
                        precision=precision, merge=merge)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned base: the
    kernel's vector loads need the row store 4-byte (int8) or 8-byte
    (fp16 / bf16) aligned, so this view takes the scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 4 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["D=7", "unaligned"])
@pytest.mark.parametrize("store", list(STORES))
def test_kernel_capacity_rows_take_scalar_loads(cuda, hosts, store, shape):
    """D = 7, and a D = 32 store viewed off its alignment: every capacity
    store loads element by element and still holds the twin."""
    kw, mode = STORES[store]
    if shape == "D=7":
        g = from_host(*_host_graph("l2", d=7), metric="l2", device=cuda,
                      **kw)
    else:
        g = _layout(hosts, "l2", device=cuda, **kw)
        if store == "quantized":
            g = g._replace(qvec=_misaligned(g.qvec))
        else:
            g = g._replace(vectors=_misaligned(g.vectors))
    q, q_sq = _queries(cuda, n=64, d=g.dim)
    for layer in (g.num_layers - 1, 0):
        ids, d = _starts(g, q, q_sq, "l2", DEFAULT, False)
        assert bs.layer_mode(g, layer, "l2", 32, 4) == mode
        _kernel_vs_twin(g, layer, q, q_sq, ids, d, P=32, E=4, metric="l2",
                        precision=DEFAULT, merge="bitonic")


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("store", list(STORES))
def test_kernel_capacity_rows_at_the_width_limit(cuda, hosts, store, merge):
    """P + E*M = 4,096 on each capacity store (the pool ends unfilled)."""
    kw, _ = STORES[store]
    g = _layout(hosts, "cosine", device=cuda, **kw)
    q, q_sq = _queries(cuda, n=16)
    ids, d = _starts(g, q, q_sq, "cosine", HIGHEST, True)
    P = bs.HOP_MAX_WIDTH - 4 * g.layer_width(0)
    hops = _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=P, E=4,
                           metric="cosine", precision=HIGHEST, merge=merge,
                           max_hops=24)
    assert hops == 24


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("store,precision", [
    ("quantized", HIGHEST), ("bfloat16", DEFAULT)])
def test_kernel_rounds_the_query_as_the_twin(cuda, hosts, store, precision,
                                             metric):
    """Non-integer data, where the query's bf16 rounding moves distances by
    far more than the tolerance: the kernel holds the twin within 1e-5
    (the int8 rows round the query at any precision, the bf16 rows at
    DEFAULT), while the same rows scored with the query unrounded part
    from the kernel's distances by more than 1e-4. A kernel that skipped
    the rounding fails here."""
    from hnsw_tpu_torch.ops.distance import gathered_epilogue
    kw, mode = STORES[store]
    g = _layout(hosts, metric, device=cuda, **kw)
    q, q_sq = _queries(cuda, n=64)
    ids, d = _starts(g, q, q_sq, metric, precision, True)
    _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=48, E=4, metric=metric,
                    precision=precision, merge="bitonic")
    kd, ki, _, _ = bs.beam_search_cuda(
        g, 0, q, q_sq, ids, d, pool_size=48, max_hops=64, metric=metric,
        precision=precision, expand=4, merge="bitonic",
        store_normalized=False)
    safe = torch.clamp(ki, 0).long()
    if mode == "qrows":
        qv = torch.einsum("bd,bcd->bc", q, g.qvec[safe].to(torch.float32))
        plain = gathered_epilogue(metric, qv * g.qscale[safe], q_sq,
                                  g.sq_norms[safe])
    else:
        plain = tsearch._score_hop(g, q, q_sq, safe, metric, HIGHEST)
    gap = float((plain - kd)[ki >= 0].abs().max())
    assert gap > 1e-4, gap


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("layout", ["split", "compact"])
def test_kernel_matches_twin_on_upper_layouts(cuda, hosts, layout, merge):
    g = _layout(hosts, "l2", layout, device=cuda)
    q, q_sq = _queries(cuda, n=64)
    for layer in range(g.num_layers - 1, 0, -1):
        ids, d = _starts(g, q, q_sq, "l2", HIGHEST, layer == 1)
        _kernel_vs_twin(g, layer, q, q_sq, ids, d, P=8, E=4, metric="l2",
                        precision=HIGHEST, merge=merge)


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_kernel_pool_at_the_width_limit_and_a_hop_cut(cuda, hosts, merge):
    """P + E*M = 4,096 (the largest pool the kernel takes: more than the
    graph holds, so it ends unfilled), and a max_hops cut of 5."""
    g = _layout(hosts, "cosine", device=cuda)
    q, q_sq = _queries(cuda, n=16)
    ids, d = _starts(g, q, q_sq, "cosine", HIGHEST, True)
    M = g.layer_width(0)
    P = bs.HOP_MAX_WIDTH - 4 * M
    hops = _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=P, E=4,
                           metric="cosine", precision=HIGHEST, merge=merge,
                           max_hops=24)
    assert hops == 24
    hops = _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=48, E=4,
                           metric="cosine", precision=HIGHEST, merge=merge,
                           max_hops=5)
    assert hops == 5


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "fp16-blocks"])
def test_kernel_odd_width_takes_scalar_loads(cuda, layout):
    """D = 30: rows and blocks load element by element."""
    arrays = _host_graph("l2", d=30)
    g = from_host(*arrays, metric="l2", device=cuda, **LAYOUTS[layout])
    q, q_sq = _queries(cuda, n=64, d=30)
    ids, d = _starts(g, q, q_sq, "l2", HIGHEST, False)
    _kernel_vs_twin(g, 0, q, q_sq, ids, d, P=32, E=4, metric="l2",
                    precision=HIGHEST, merge="bitonic")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bench", "quantized", "float16",
                                  "bfloat16"])
def test_graph_search_launches_once_per_layer(cuda, mode):
    """Graph.batch_search_slots on the card: since K5 one launch a batch,
    whatever the layer count (bench's mode: layer 0 on blocks; each
    hbm_mode and the bf16 store: every layer in its store's mode), no K2
    launch and no search on the plain version; the same hops a layer as
    the plain version with one K2 launch a layer; and the results the
    plain twin (no K2, no K5) gives on the same graph."""
    import dataclasses
    from hnsw_tpu_torch.ops import graph_search as gs
    v = _data(3, 6000)
    q = _data(4, 64)
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, seed=0, device=cuda)
    g.build(list(range(len(v))), v, method="host")
    g.native_serve_max_batch = 0
    if mode == "bench":
        g.fast_math = True
        g.block_layout = True
        g.entry_mode = "pivots"
    elif mode in ("quantized", "float16"):
        g.hbm_mode = mode
    elif mode == "bfloat16":
        g.cfg = dataclasses.replace(g.cfg, store_dtype="bfloat16")
        g._dirty = True

    def reset():
        _reset()
        gs.launches = 0
        gs.launches_by_mode.update(dict.fromkeys(bs.MODES, 0))
        gs.plain_on_cuda.update(mode=0, size=0, other=0)

    reset()
    d, i = g.batch_search_slots(q, 10, ef=64)
    layers = 1 if mode == "bench" else g.device_graph().num_layers
    mode0 = {"default": "rows", "bench": "blocks", "quantized": "qrows",
             "float16": "f16rows", "bfloat16": "bf16rows"}[mode]
    assert gs.launches == 1 and bs.launches == 0
    assert len(g.last_search_hops) == layers
    assert gs.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert gs.launches_by_mode == {m: int(m == mode0) for m in bs.MODES}
    hops = list(g.last_search_hops)
    with gs.plain():
        reset()
        g.batch_search_slots(q, 10, ef=64)
        assert gs.launches == 0 and bs.launches == layers
        assert bs.twin_layers_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert g.last_search_hops == hops
    with gs.plain(twin=True):
        reset()
        dt, it = g.batch_search_slots(q, 10, ef=64)
        assert gs.launches == 0 and bs.launches == 0
    assert g.last_search_hops == hops
    ov, err = _overlap_and_err(d, i, dt, it)
    assert ov >= 0.99 and err <= 1e-5, (ov, err)


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_kernel_work_counts_match_the_twins_reads(cuda, hosts, merge):
    """The kernel's work counts (nodes expanded, candidates scored) against
    the twin's ``touched`` ids on the same inputs: the same nodes; the same
    candidates with the sort merge, and no more with the bitonic one (the
    kernel drops a hop's duplicate ids before it scores them, the twin
    after)."""
    g = _layout(hosts, "l2", device=cuda)
    q, q_sq = _queries(cuda, n=64)
    ids, d = _starts(g, q, q_sq, "l2", HIGHEST, True)
    kw = dict(pool_size=32, max_hops=64, metric="l2", precision=HIGHEST,
              expand=4, merge=merge, store_normalized=False)
    _, _, _, work = bs.beam_search_cuda(g, 0, q, q_sq, ids, d, **kw)
    touched = {}
    tsearch.beam_search_layer_reference(g, 0, q, q_sq, ids, d,
                                        touched=touched, **kw)
    nodes = sum(t.numel() for t in touched["nodes"])
    rows = sum(t.numel() for t in touched["rows"])
    w = work.sum(0).tolist()
    assert w[0] == nodes
    assert (w[1] == rows) if merge == "sort" else (0 < w[1] <= rows)


@pytest.mark.cuda
def test_smem_bytes_match_the_library(cuda):
    lib = bs._load()
    for D, P, E, M, merge in ((128, 512, 4, 32, "bitonic"),
                              (30, 64, 1, 16, "sort"),
                              (960, 3968, 4, 32, "bitonic"),
                              (128, 64, 4, 32, "bitonic"),
                              (128, 192, 4, 32, "bitonic"),
                              (128, 100, 4, 32, "sort"),
                              (128, 3968, 4, 32, "sort"),
                              (7, 8, 4, 16, "bitonic"),
                              (128, 4088, 1, 8, "sort")):
        nbytes = lib.beam_search_smem_bytes(D, P, E, M, int(merge == "sort"))
        assert nbytes == bs.smem_bytes(D, P, E, M, merge)
        # every instantiation (seven scoring modes, vector and scalar
        # loads) launches at that shared memory
        for score in range(7):
            for vec in (0, 1):
                assert lib.beam_search_blocks_per_sm(score, vec,
                                                     nbytes) >= 1
    assert lib.beam_search_blocks_per_sm(7, 0, 1024) == -1


def _int_graph(device, **store):
    """An l2 graph on small-integer rows, a fifth of them copies of
    others: distances are exact in f32 on either side (and in bf16), so
    equal distances tie exactly and the kernel must order them as the
    twin does. ``store``: from_host's store arguments (fp16 and bf16 hold
    the integers exactly; the int8 rows' Gram is an exact integer sum
    times the row's scale, the same one rounding on either side)."""
    r = np.random.default_rng(11)
    v = r.integers(-2, 3, (2500, 32)).astype(np.float32)
    v[2000:] = v[:500]
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, metric="l2", seed=3,
                             device="cpu")
    g.build(list(range(len(v))), v, method="host")
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    q = torch.from_numpy(
        r.integers(-2, 3, (64, 32)).astype(np.float32)).to(device)
    return (from_host(g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
                      levels[:n], g.store.alive[:n], entry,
                      metric="sqeuclidean", device=device, **store),
            q, torch.sum(q * q, dim=-1))


def _kernel_equals_twin(g, q, q_sq, ids, d, **kw):
    """One launch against the twin: the same pools, bit for bit, the same
    hop counts. Returns (ids, the kernel's work [B, 2], the twin's rows
    scored)."""
    _reset()
    ks, ts, touched = {}, {}, {}
    kd, ki = tsearch.beam_search_layer(g, 0, q, q_sq, ids, d, stats=ks, **kw)
    torch.cuda.synchronize()
    assert bs.launches == 1
    rd, ri = tsearch.beam_search_layer_reference(g, 0, q, q_sq, ids, d,
                                                 stats=ts, touched=touched,
                                                 **kw)
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_array_equal(kd.cpu().numpy(), rd.cpu().numpy())
    assert ks["hops"] == ts["hops"]
    _, _, _, work = bs.beam_search_cuda(g, 0, q, q_sq, ids, d, **kw)
    return (ki.cpu().numpy(), work.cpu().numpy(),
            sum(t.numel() for t in touched["rows"]))


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("precision", [HIGHEST, DEFAULT])
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_kernel_breaks_ties_as_the_twin(cuda, merge, precision, expand):
    """Equal distances (copied rows, integer data): the kernel ranks by
    (distance, slot) and merges as the twin's network or stable sort does,
    so the pools are equal bit for bit, ties included."""
    g, q, q_sq = _int_graph(cuda)
    ids, d = _starts(g, q, q_sq, "sqeuclidean", precision, True)
    kw = dict(pool_size=48, max_hops=64, metric="sqeuclidean",
              precision=precision, expand=expand, merge=merge,
              store_normalized=False)
    ki, _, _ = _kernel_equals_twin(g, q, q_sq, ids, d, **kw)
    dist = torch.sum((q[:, None, :] - g.vectors[torch.clamp(
        torch.from_numpy(ki).to(cuda), 0).long()]) ** 2, -1).cpu().numpy()
    fin = ki >= 0
    ties = sum(len(row[f]) - len(np.unique(row[f]))
               for row, f in zip(dist, fin))
    assert ties > 0                        # the pools do hold equal distances


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("store", list(STORES))
def test_kernel_breaks_ties_as_the_twin_on_capacity_rows(cuda, store,
                                                         merge):
    """Equal distances on each capacity store: the pools equal the twin's
    bit for bit, ties included."""
    g, q, q_sq = _int_graph(cuda, **STORES[store][0])
    assert bs.layer_mode(g, 0, "sqeuclidean", 48, 4, merge) \
        == STORES[store][1]
    ids, d = _starts(g, q, q_sq, "sqeuclidean", DEFAULT, True)
    kw = dict(pool_size=48, max_hops=64, metric="sqeuclidean",
              precision=DEFAULT, expand=4, merge=merge,
              store_normalized=False)
    ki, _, _ = _kernel_equals_twin(g, q, q_sq, ids, d, **kw)
    kt = torch.from_numpy(ki).to(cuda)
    dist = tsearch._score_hop(g, q, q_sq, torch.clamp(kt, 0), "sqeuclidean",
                              DEFAULT).cpu().numpy()
    fin = ki >= 0
    ties = sum(len(row[f]) - len(np.unique(row[f]))
               for row, f in zip(dist, fin))
    assert ties > 0                        # the pools do hold equal distances


@pytest.mark.cuda
def test_kernel_drops_same_hop_diamonds_as_the_twin(cuda):
    """Bitonic merge, E = 4: nodes expanded in one hop share neighbours
    (diamonds). The kernel scores each id once (its lowest slot), so it
    scores fewer rows than the twin reads, and its pools equal the twin's,
    which masks the later copies after scoring."""
    g, q, q_sq = _int_graph(cuda)
    ids, d = _starts(g, q, q_sq, "sqeuclidean", HIGHEST, False)
    kw = dict(pool_size=32, max_hops=64, metric="sqeuclidean",
              precision=HIGHEST, expand=4, merge="bitonic",
              store_normalized=False)
    _, work, twin_rows = _kernel_equals_twin(g, q, q_sq, ids, d, **kw)
    assert 0 < int(work[:, 1].sum()) < twin_rows


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_kernel_masks_an_inf_start_entry(cuda, merge):
    """A start entry at INF with a valid id (the refine seeds a node with
    itself at INF) still masks that id: in the first hop the entry's
    neighbour seeded so is not scored (one row fewer than the entry's
    neighbours) and does not leave the pool at a finite distance. Over
    all hops the pools equal the twin's."""
    g, q, q_sq = _int_graph(cuda)
    B = q.shape[0]
    entry = int(g.entry)
    row = g.neighbors[0, entry]
    nbr = int(row[row >= 0][0])
    ids = torch.tensor([[entry, nbr]] * B, dtype=torch.int32, device=cuda)
    d = tsearch._score_hop(g, q, q_sq, ids, "sqeuclidean", HIGHEST)
    d[:, 1] = INF
    for max_hops in (1, 64):
        kw = dict(pool_size=32, max_hops=max_hops, metric="sqeuclidean",
                  precision=HIGHEST, expand=4, merge=merge,
                  store_normalized=False)
        ki, work, _ = _kernel_equals_twin(g, q, q_sq, ids, d, **kw)
        if max_hops == 1:
            assert not (ki == nbr).any()
            assert (work[:, 1] == int((row >= 0).sum()) - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [64, 192])
def test_a_full_batch_fits_one_wave(cuda, ef):
    """1,024 queries at the smoke's shape (D = 128, m = 16: M0 = 32, E =
    4): by the occupancy API every instantiation the graph tier launches
    keeps a block of each query resident at once on this card, and the
    launch holds the twin."""
    r = np.random.default_rng(7)
    v = r.standard_normal((6000, 128)).astype(np.float32)
    g = hnsw_tpu_torch.Graph(m=16, ef_construction=64, metric="cosine",
                             seed=0, device="cpu")
    g.build(list(range(len(v))), v, method="host")
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    dg = from_host(g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
                   levels[:n], g.store.alive[:n], entry, metric="cosine",
                   device=cuda)
    assert dg.layer_width(0) == 32
    lib = bs._load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for merge in ("bitonic", "sort"):
        nbytes = bs.smem_bytes(128, ef, 4, 32, merge)
        for score in range(7):
            per_sm = lib.beam_search_blocks_per_sm(score, 1, nbytes)
            assert per_sm * sms >= 1024, (merge, score, per_sm, sms)
    q, q_sq = _queries(cuda, n=1024, d=128)
    ids, d = _starts(dg, q, q_sq, "cosine", HIGHEST, False)
    _kernel_vs_twin(dg, 0, q, q_sq, ids, d, P=ef, E=4, metric="cosine",
                    precision=HIGHEST, merge="bitonic", max_hops=128)


@pytest.mark.cuda
def test_wrapper_raises_when_the_library_fails_to_load(cuda, hosts,
                                                       monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed (1): simulated")
    g = _layout(hosts, "l2", device=cuda)
    q, q_sq = _queries(cuda, n=4)
    ids, d = _starts(g, q, q_sq, "l2", HIGHEST, False)
    monkeypatch.setattr(bs, "_lib", None)
    monkeypatch.setattr(bs, "build", broken)
    _reset()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tsearch.beam_search_layer(g, 0, q, q_sq, ids, d, 16, 64, "l2",
                                  HIGHEST, expand=4, merge="bitonic")
    assert bs.launches == 0
