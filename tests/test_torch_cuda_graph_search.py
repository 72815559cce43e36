"""K5, the whole-search kernel, against its plain version on the card.

``core/search.search_graph`` runs a search as one launch of
``ops/graph_search.graph_search_cuda`` where
``ops/graph_search.search_kernel_applies`` holds, else
``search_graph_reference`` (one ``beam_search_layer`` a layer: K2 launches
on the card). Every test here is marked ``cuda`` (skipped without an
NVIDIA GPU; decided in the fixture) and holds K5 to the plain version on
the same graph and queries twice: with one K2 launch a layer, and with
K2's plain twin a layer (``ops/graph_search.plain(twin=True)``), so that
a fault in K2's layer code, which K5 shares, shows. The cases: the
layouts and stores ``from_host`` makes (dense, split and compact uppers,
f32 / fp16 / bf16 stores, the int8 capacity mode, int8 and fp16 layer-0
blocks), descent and seeded entry, ``fast_math`` on and off,
``device_rerank`` on and off, ``ef_upper`` 0 and 16. On Gaussian data ids
overlap >= 0.99 and the distances of shared ids agree within 1e-5 x
max(1, |d|) (1e-3 on int8 blocks where no f32 rerank rescored them: their
squared norms are f32 sums rounded to bf16). On integer data the results
equal the K2 pass's bit for bit (each layer is K2's device code) and the
twin's too, except on int8 blocks, whose rows quantised at a scale of
2/127 sum in another order there. Hop counts a layer are equal
everywhere. Each of the 15 (layer 0, upper layers) mode pairs the kernel
has runs on integer data; widths D = 7, 50, 128 and 132 at ef 64 and
past the solo merge (P0 + E*M > 512); rows repeated four times tie in
the upper layers at ef_upper 8 and 32. On a float batch of the
benchmark's shape (the sift1m cell's graph at 131,072 rows, built by the
benchmark's own set-up, ef 64 and 192, 8,192 queries) K5, which asks the
L2 cache for no row ahead, equals K2 a layer, which does, bit for bit; a
launch of the residency probe's build (tools/graph_split.py,
GRAPH_RESIDENCY_PAD), padded to fewer resident blocks, gives the same
results. Run on a GPU machine with
``python3 -m pytest --noconftest tests/test_torch_cuda_graph_search.py -m
cuda``. This file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hnsw_tpu_torch  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from hnsw_tpu_torch.core.state import from_host  # noqa: E402
from hnsw_tpu_torch.ops import beam_search as bs  # noqa: E402
from hnsw_tpu_torch.ops import graph_search as gs  # noqa: E402
from hnsw_tpu_torch.ops.distance import INF_DIST  # noqa: E402

INF = float(INF_DIST)
#: from_host keyword arguments of each layout and store
LAYOUTS = {"dense": {}, "split": dict(split_layers=True, upper_m=8),
           "compact": dict(split_layers="compact", upper_m=8),
           "int8-blocks": dict(block_layout=True, block_dtype="int8"),
           "fp16-blocks": dict(block_layout=True, block_dtype="float16"),
           "quantized": dict(quantize=True, hbm_vectors=False),
           "float16": dict(store_dtype="float16"),
           "bfloat16": dict(store_dtype="bfloat16")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _arrays(metric, v):
    g = hnsw_tpu_torch.Graph(m=8, ef_construction=64, metric=metric, seed=3,
                             device="cpu")
    g.build(list(range(len(v))), v, method="host")
    g.batch_delete(list(range(0, len(v), 50)))      # tombstones
    n = g.slots.capacity_used
    nb, levels, entry, _ = g.host.arrays()
    return (g.store.vectors[:n], g.store.sq_norms[:n], nb[:, :n],
            levels[:n], g.store.alive[:n], entry)


@pytest.fixture(scope="module")
def hosts():
    """Host arrays of a 2,500-row graph per metric (Gaussian, D = 32), and
    of an integer-valued one (entries in -2..2, a fifth copies)."""
    r = np.random.default_rng(11)
    iv = r.integers(-2, 3, (2500, 32)).astype(np.float32)
    iv[2000:] = iv[:500]
    return {"cosine": _arrays("cosine", _data(1, 2500)),
            "l2": _arrays("l2", _data(1, 2500)),
            "int": _arrays("l2", iv)}


def _reset():
    gs.launches = 0
    gs.launches_by_mode.update(dict.fromkeys(bs.MODES, 0))
    gs.plain_on_cuda.update(mode=0, size=0, other=0)


def _seeds(g, B, device, seed=0):
    """[B, 6] seeds: a repeated id, a -1 pad, the rest valid slots."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, 2400, (B, 6)).astype(np.int32)
    ids[:, 1] = ids[:, 0]
    ids[:, 2] = -1
    return torch.from_numpy(ids).to(device)


def _compare(kd, ki, pd, pi, *, tol, exact):
    """ids equal with ``exact`` (and distances bit for bit), else
    overlapping >= 0.99; distances of shared ids within tol x max(1,
    |d|)."""
    assert ki.shape == pi.shape
    if exact:
        np.testing.assert_array_equal(ki, pi)
        np.testing.assert_array_equal(kd, pd)
    hits, err = 0, 0.0
    for rkd, rki, rpd, rpi in zip(kd, ki, pd, pi):
        pos = {int(x): j for j, x in enumerate(rki) if x >= 0}
        for j, x in enumerate(rpi):
            if x >= 0 and int(x) in pos:
                hits += 1
                a, b = float(rkd[pos[int(x)]]), float(rpd[j])
                err = max(err, abs(a - b) / max(1.0, abs(b)))
    n = int((pi >= 0).sum())
    ov = hits / n if n else 1.0
    assert ov >= 0.99 and err <= tol, (ov, err)


def _k5_vs_plain(g, q, *, tol=1e-5, exact=False, twin_exact=None, **kw):
    """One K5 launch against the plain version on the same inputs, twice:
    search_graph_reference with one K2 launch a layer (K5 runs K2's layer
    code, so ``exact`` asks for equal ids and distances), and with K2's
    plain twin a layer, so that no device code of K5's is on the
    reference side (``twin_exact``, default ``exact``, asks the same of
    it). Ids overlap >= 0.99 otherwise, distances of shared ids within
    tol x max(1, |d|), hop counts equal a layer. Returns (ids, hops)."""
    _reset()
    ks = {}
    kd, ki = tsearch.results_to_host(
        *tsearch.search_graph(g, q, stats=ks, **kw), ks)
    assert gs.launches == 1, gs.launches
    assert gs.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    assert ki.shape == (q.shape[0], kw["k"])
    assert ((ki < 0) == (kd >= INF)).all()
    hq = ks["hops_by_query"].numpy()
    assert hq.shape == (len(ks["hops"]), q.shape[0])
    assert hq.max(axis=1).tolist() == ks["hops"]
    for twin in (False, True):
        ps = {}
        bs.launches = 0
        with gs.plain(twin=twin):
            pd, pi = tsearch.results_to_host(
                *tsearch.search_graph_reference(g, q, stats=ps, **kw), ps)
        assert bs.launches == (0 if twin else len(ps["hops"]))
        _compare(kd, ki, pd, pi, tol=tol,
                 exact=(twin_exact if twin and twin_exact is not None
                        else exact))
        assert ks["hops"] == ps["hops"], (twin, ks["hops"], ps["hops"])
    return ki, ks["hops"]


@pytest.mark.cuda
@pytest.mark.parametrize("ef_upper", [0, 16])
@pytest.mark.parametrize("device_rerank", [True, False])
@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("entry", ["descent", "seeded"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k5_matches_the_plain_version(cuda, hosts, layout, entry,
                                      fast_math, device_rerank, ef_upper):
    metric = "cosine" if layout in ("dense", "int8-blocks") else "l2"
    g = from_host(*hosts[metric], metric=metric, device=cuda,
                  **LAYOUTS[layout])
    q = torch.from_numpy(_data(2, 64)).to(cuda)
    seeds = _seeds(g, 64, cuda) if entry == "seeded" else None
    _, hops = _k5_vs_plain(
        g, q, k=10, ef=48, metric=metric, max_hops=64, expand=4,
        merge="bitonic" if fast_math else "sort", fast_math=fast_math,
        device_rerank=device_rerank, ef_upper=ef_upper, seed_ids=seeds,
        store_normalized=metric == "cosine",
        tol=1e-3 if layout == "int8-blocks" and not (
            fast_math and device_rerank) else 1e-5)
    assert len(hops) == (1 if seeds is not None else g.num_layers)
    want = bs.layer_mode(g, 0, metric, 48, 4)
    assert gs.launches_by_mode[want] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
def test_k5_matches_the_plain_version_in_every_metric(cuda, hosts, metric,
                                                      merge):
    g = from_host(*hosts["cosine" if metric == "cosine" else "l2"],
                  metric=metric, device=cuda)
    q = torch.from_numpy(_data(3, 64)).to(cuda)
    for expand in (1, 4):
        _k5_vs_plain(g, q, k=10, ef=32, metric=metric, expand=expand,
                     merge=merge, store_normalized=metric == "cosine")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "quantized", "float16",
                                    "bfloat16", "int8-blocks"])
@pytest.mark.parametrize("fast_math", [False, True])
def test_k5_equals_the_plain_version_on_integer_data(cuda, hosts, layout,
                                                     fast_math):
    """The same ids and distances, ties (a fifth of the rows are copies)
    in the same order, the rerank's ties in pool order: against the twin
    too wherever every distance is exact (not on int8 blocks)."""
    g = from_host(*hosts["int"], metric="sqeuclidean", device=cuda,
                  **LAYOUTS[layout])
    r = np.random.default_rng(5)
    q = torch.from_numpy(r.integers(-2, 3, (64, 32)).astype(np.float32)
                         ).to(cuda)
    for entry in (None, _seeds(g, 64, cuda)):
        ki, _ = _k5_vs_plain(g, q, k=10, ef=48, metric="sqeuclidean",
                             expand=4, merge="sort", fast_math=fast_math,
                             seed_ids=entry, exact=True,
                             twin_exact=layout != "int8-blocks")
        assert (ki >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True])
def test_k5_seeds_all_missing_and_inf_entries(cuda, hosts, fast_math):
    """Seeds all -1: no entry, no hop, every result (INF, -1). Seeds whose
    first entries are -1 pads (INF) before valid ids: as the plain
    version."""
    g = from_host(*hosts["int"], metric="sqeuclidean", device=cuda)
    q = torch.from_numpy(_data(4, 32)).to(cuda)
    kw = dict(k=10, ef=32, metric="sqeuclidean", expand=4, merge="bitonic",
              fast_math=fast_math)
    none = torch.full((32, 5), -1, dtype=torch.int32, device=cuda)
    ki, hops = _k5_vs_plain(g, q, seed_ids=none, exact=True, **kw)
    assert (ki == -1).all() and hops == [0]
    seeds = _seeds(g, 32, cuda)
    seeds[:, :3] = -1
    _k5_vs_plain(g, q, seed_ids=seeds, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_k5_pool_and_width_at_the_limits(cuda, hosts, merge):
    """Layer 0's P0 + E*M0 = 4,096 (the widest pool K2 takes; the graph
    holds fewer rows, so it ends unfilled) with k = P0 and a 24-hop cut,
    and the upper layers at ef_upper = 512: one launch, the plain
    version's results and hops."""
    g = from_host(*hosts["l2"], metric="l2", device=cuda)
    q = torch.from_numpy(_data(5, 16)).to(cuda)
    P0 = bs.HOP_MAX_WIDTH - 4 * g.layer_width(0)
    kw = dict(metric="l2", expand=4, merge=merge, max_hops=24)
    assert gs.search_kernel_applies(g, "l2", q, P0, 512, 4, merge)
    assert not gs.search_kernel_applies(g, "l2", q, P0 + 1, 8, 4, merge)
    _, hops = _k5_vs_plain(g, q, k=P0, ef=P0, **kw)
    assert hops[-1] == 24
    _k5_vs_plain(g, q, k=10, ef=64, ef_upper=512, **kw)
    _reset()
    tsearch.search_graph(g, q, k=10, ef=P0 + 1, **kw)
    assert gs.launches == 0 and gs.plain_on_cuda["size"] == 1


@pytest.mark.cuda
def test_graph_search_smem_bytes_match_the_library(cuda):
    lib = gs._load()
    for args in ((128, 8, 4, 16, 8, 64, 4, 32, "bitonic", 1),
                 (128, 8, 4, 16, 0, 192, 4, 32, "sort", 16),
                 (30, 512, 4, 8, 3, 64, 1, 16, "sort", 1),
                 (128, 8, 1, 16, 8, 3968, 4, 32, "bitonic", 1),
                 (7, 8, 4, 16, 2, 8, 4, 16, "bitonic", 7)):
        *head, merge, n_seed = args
        nbytes = lib.graph_search_smem_bytes(*head, int(merge == "sort"),
                                             n_seed)
        assert nbytes == gs.smem_bytes(*head, merge, n_seed), args
    assert lib.graph_search_blocks_per_sm(0, 1, 0, 1024) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [64, 192])
def test_a_full_batch_fits_one_wave(cuda, ef):
    """1,024 queries at the smoke's shape (D = 128, m = 16: M0 = 32, E =
    4, the uppers' 8-wide pool): by the occupancy API every instantiation
    the graph tier launches keeps a block of each query resident at once,
    and the launch holds the plain version."""
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
    lib = gs._load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = [(s, s) for s in (0, 1, 4, 5, 6)] + [
        (b, u) for b in (2, 3) for u in (0, 1, 4, 5, 6)]
    for merge in ("bitonic", "sort"):
        for n_up, n_seed in ((dg.num_layers - 1, 1), (0, 16)):
            nbytes = gs.smem_bytes(128, 8, 4, 16, n_up, ef, 4, 32, merge,
                                   n_seed)
            for s0, su in pairs:
                per_sm = lib.graph_search_blocks_per_sm(s0, su, 1, nbytes)
                assert per_sm * sms >= 1024, (merge, s0, su, per_sm)
    q = torch.from_numpy(r.standard_normal((1024, 128)).astype(np.float32)
                         ).to(cuda)
    _k5_vs_plain(dg, q, k=10, ef=ef, metric="cosine", expand=4,
                 merge="bitonic", store_normalized=True)


@pytest.mark.cuda
def test_k5_makes_no_host_sync(cuda, hosts):
    """The search itself never waits for the card: under
    torch.cuda.set_sync_debug_mode("error") a descent and a seeded search
    run; the one copy of the results and hop counts comes after."""
    g = from_host(*hosts["l2"], metric="l2", device=cuda,
                  **LAYOUTS["int8-blocks"])
    q = torch.from_numpy(_data(6, 64)).to(cuda)
    seeds = _seeds(g, 64, cuda)
    torch.cuda.synchronize()
    for s in (None, seeds):
        stats = {}
        _reset()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d, i = tsearch.search_graph(g, q, k=10, ef=48, metric="l2",
                                        fast_math=True, seed_ids=s,
                                        stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert gs.launches == 1 and "hops" not in stats
        dh, ih = tsearch.results_to_host(d, i, stats)
        assert ih.shape == (64, 10) and len(stats["hops"]) == (
            g.num_layers if s is None else 1)
        np.testing.assert_array_equal(ih, i.cpu().numpy())


@pytest.mark.cuda
def test_wrapper_raises_when_the_library_fails_to_load(cuda, hosts,
                                                       monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed (1): simulated")
    g = from_host(*hosts["l2"], metric="l2", device=cuda)
    q = torch.from_numpy(_data(7, 4)).to(cuda)
    monkeypatch.setattr(bs, "_lib", None)
    monkeypatch.setattr(bs, "build", broken)
    _reset()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tsearch.search_graph(g, q, k=10, ef=32, metric="l2")
    assert gs.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
@pytest.mark.parametrize("D", [7, 50, 128, 132])
def test_k5_at_its_limits(cuda, D, merge):
    """D = 7 and 50 (no whole-row vector loads), 128 and 132 (a row one
    16-byte unit past 128's), at ef 64 and with a pool past 512 entries
    with the candidates (the block-wide rank and merge): the plain
    version's ids and hops, K2 a layer and K2's twin."""
    r = np.random.default_rng(D)
    v = (r.standard_normal((3000, D)) / np.sqrt(D)).astype(np.float32)
    dg = from_host(*_arrays("l2", v), metric="l2", device=cuda)
    q = torch.from_numpy(
        (r.standard_normal((48, D)) / np.sqrt(D)).astype(np.float32)).to(cuda)
    kw = dict(k=10, metric="l2", expand=4, merge=merge)
    _k5_vs_plain(dg, q, ef=64, **kw)
    assert 480 + 4 * dg.layer_width(0) > 512
    _k5_vs_plain(dg, q, ef=480, **kw)


#: every pair of scoring modes K5 has (layer 0's, the upper layers'):
#: from_host keyword arguments and fast_math
PAIRS = {
    "f32+f32": ({}, False),
    "bf16+bf16": ({}, True),
    "qrows+qrows": (dict(quantize=True, hbm_vectors=False), False),
    "f16rows+f16rows": (dict(store_dtype="float16"), False),
    "bf16rows+bf16rows": (dict(store_dtype="bfloat16"), False),
    **{f"{b}+{u}": (dict(block_layout=True, block_dtype=dt, **kw), fm)
       for b, dt in (("int8", "int8"), ("fp16", "float16"))
       for u, kw, fm in (("f32", {}, False), ("bf16", {}, True),
                         ("qrows", dict(hbm_vectors=False), False),
                         ("f16rows", dict(store_dtype="float16"), False),
                         ("bf16rows", dict(store_dtype="bfloat16"), False))}}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(PAIRS))
def test_every_pair_of_modes_against_the_plain_version(cuda, hosts, pair):
    """Each of the 15 (SCORE0, SCOREUP) instantiations on integer data:
    ids and hop counts a layer equal to search_graph_reference's (K2 a
    layer, bit for bit; K2's twin: distances within 1e-5 x max(1, |d|),
    ids equal but on int8 blocks)."""
    layout, fast_math = PAIRS[pair]
    g = from_host(*hosts["int"], metric="sqeuclidean", device=cuda, **layout)
    precision = "default" if fast_math else "highest"
    mode0 = bs.layer_mode(g, 0, "sqeuclidean", 48, 4, "sort")
    names = {0: "f32", 1: "bf16", 2: "int8", 3: "fp16", 4: "qrows",
             5: "f16rows", 6: "bf16rows"}
    assert (f"{names[bs.score_code(g, mode0, precision)]}+"
            f"{names[bs.score_code(g, gs.row_mode(g), precision)]}") == pair
    r = np.random.default_rng(9)
    q = torch.from_numpy(r.integers(-2, 3, (64, 32)).astype(np.float32)
                         ).to(cuda)
    ki, hops = _k5_vs_plain(g, q, k=10, ef=48, metric="sqeuclidean",
                            expand=4, merge="sort", fast_math=fast_math,
                            exact=True,
                            twin_exact=not pair.startswith("int8"))
    assert (ki >= 0).all() and len(hops) == g.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["bitonic", "sort"])
def test_upper_layer_ties_keep_their_order(cuda, merge):
    """Integer rows with many equal distances (every row repeated four
    times) at ef_upper 8 and 32: the upper layers' pools, their hand-offs
    and layer 0's give K2's a layer and the twin's bit for bit (a rank by
    (distance, slot), the bitonic network's tie order)."""
    r = np.random.default_rng(13)
    base = r.integers(-1, 2, (600, 32)).astype(np.float32)
    v = np.concatenate([base] * 4)
    g = from_host(*_arrays("l2", v), metric="sqeuclidean", device=cuda)
    q = torch.from_numpy(r.integers(-1, 2, (64, 32)).astype(np.float32)
                         ).to(cuda)
    for ef_upper in (8, 32):
        kw = dict(k=10, ef=32, ef_upper=ef_upper, metric="sqeuclidean",
                  expand=4, merge=merge)
        ki, hops = _k5_vs_plain(g, q, exact=True, **kw)
        assert (ki >= 0).all() and len(hops) == g.num_layers > 1


@pytest.fixture(scope="module")
def pad_lib(tmp_path_factory):
    """The residency probe's build of the kernel (GRAPH_RESIDENCY_PAD)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from hnsw_tpu_torch.tools import graph_split as gsp
    return gsp.pad_library(bs.build(
        (gsp.PAD,), str(tmp_path_factory.mktemp("graph_split_pad"))))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [2, 4])
def test_padded_launch_caps_residency_and_changes_nothing(cuda, hosts,
                                                          pad_lib, blocks):
    """The probe's build padded by tools/graph_split.resident_pad leaves
    just ``blocks`` blocks an SM by the occupancy API, and its padded
    launch's results and hop counts equal the shipped library's bit for
    bit."""
    from hnsw_tpu_torch.tools.graph_split import resident_pad
    g = from_host(*hosts["l2"], metric="l2", device=cuda)
    q = torch.from_numpy(_data(40, 256)).to(cuda)
    plan = gs.search_kernel_applies(g, "l2", q, 64, 8, 4, "bitonic")
    pad = resident_pad(plan["smem"], blocks)
    assert pad_lib.graph_search_blocks_per_sm(0, 0, 1, plan["smem"] + pad) \
        == blocks
    kw = dict(k=10, ef=64, metric="l2", expand=4, merge="bitonic")
    out = []
    shipped = gs._load()
    for lib, n in ((shipped, 0), (pad_lib, pad)):
        st = {}
        bs._lib = lib
        pad_lib.graph_search_set_pad(n)
        try:
            d, i = tsearch.results_to_host(
                *tsearch.search_graph(g, q, stats=st, **kw), st)
        finally:
            pad_lib.graph_search_set_pad(0)
            bs._lib = shipped
        out.append((d, i, st["hops_by_query"].numpy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [64, 192])
def test_k5_equals_k2_a_layer_on_a_float_batch_of_the_benchmarks_shape(
        cuda, ef):
    """The benchmark's shape on float data: the sift1m cell's graph at
    131,072 rows (more than L2 holds), drawn and built on the card by the
    benchmark's set-up (D 128, m 16, m0 32, L2), 8,192 queries, expand 4:
    K5's distances, ids and hop counts equal K2 a layer's bit for bit (the
    twin sums in another order and is held to K5 on smaller batches
    above)."""
    from hnsw_tpu_torch.tools.graph_split import rows_graph
    g, pool, _ = rows_graph(131_072)
    q = torch.from_numpy(pool[:8192]).to(cuda)
    dg = g.device_graph()
    kw = dict(k=10, ef=ef, metric="l2", expand=4, merge="bitonic",
              max_hops=128)
    _reset()
    ks, ps = {}, {}
    kd, ki = tsearch.results_to_host(
        *tsearch.search_graph(dg, q, stats=ks, **kw), ks)
    assert gs.launches == 1
    bs.launches = 0
    with gs.plain():
        pd, pi = tsearch.results_to_host(
            *tsearch.search_graph_reference(dg, q, stats=ps, **kw), ps)
    assert bs.launches == len(ps["hops"]) == dg.num_layers
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kd, pd)
    assert ks["hops"] == ps["hops"] and (ki >= 0).all()
