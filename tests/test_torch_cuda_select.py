"""The wave builder's neighbour-selection kernel (K4) against its twin, on
the card.

``core/build._diverse_select_dev`` runs one launch of
``csrc/diverse_select.cu`` where ``ops/diverse_select.select_kernel_applies``
(CUDA tensors, a built-in metric, a float32 / float16 / bfloat16 row
store, C <= 1,024), else the twin ``_diverse_select_reference``. Both run
here on the same CUDA tensors.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these tests skip where
there is no NVIDIA GPU (decided inside the fixture, never at import).
This file imports no JAX; run it on a GPU machine with
``python3 -m pytest --noconftest tests/test_torch_cuda_select.py -m cuda``.

Tolerances: on integer-valued rows (|x| <= 4) every bf16 operand, product
and f32 sum is exact, so the rows must be EQUAL for l2, sqeuclidean and
dot, at every width the builder gives the selection (C 96 / deg 32, C 64
/ deg 32, C 64 / deg 16, C 20 / deg 32), D 7 / 50 / 128 / 300, both
values of ``diversify``, the fp16 and bf16 stores, C 256 and C 1,024.
Cosine goes through rsqrt and is held to a row overlap >= 0.99 there. On
Gaussian rows at the smoke's layer-0 shape (P 2,048, C 96, deg 32, D 128)
the kernel's Gram sums run in another order than the twin's matmul, which
can flip a conflict at a near-tie: at least 0.999 of the rows equal.

The kernel pads C and D to multiples of 16 and stages D in slabs where a
row's candidates do not fit its block whole (``ops/diverse_select.layout``):
C across the padding (1 .. 1,024), D 7 / 50 / 65 / 128 / 300 in every
store, the slab path (C 1,024 at D 128, C 256 at D 300) and the same inputs
through a build whose row budget moves the threshold (slabs against whole
rows, equal rows).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu_torch.core import build as tbuild  # noqa: E402
from hnsw_tpu_torch.core import build_device as tbd  # noqa: E402
from hnsw_tpu_torch.ops import diverse_select as ds  # noqa: E402
from hnsw_tpu_torch.ops.distance import (INF_DIST,  # noqa: E402
                                         register_distance)

pytestmark = pytest.mark.cuda

INF = float(INF_DIST)
METRICS = ["l2", "sqeuclidean", "dot", "cosine"]
WIDTHS = [(96, 32), (64, 32), (64, 16), (20, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _reset():
    ds.launches = 0
    ds.plain_on_cuda.update(mode=0, size=0, other=0)


def _store(seed, n, d, device, dtype=torch.float32, gaussian=False):
    r = np.random.default_rng(seed)
    v = (r.standard_normal((n, d)) if gaussian
         else r.integers(-4, 5, (n, d))).astype(np.float32)
    t = torch.from_numpy(v).to(device)
    t32 = t.to(dtype).to(torch.float32)
    return t.to(dtype), (t32 * t32).sum(-1)


def _batch(seed, vectors, sq, P, C, metric, near=False):
    """[P, C] candidates scored against an anchor a row at HIGHEST, as the
    builder scores them (build_device._row_dist_dense): random ids (or,
    ``near``, each anchor's C nearest rows) with a repeated id and 15%
    pads; row 0 all pads, row 1 all pads but five."""
    r = np.random.default_rng(seed)
    n = vectors.shape[0]
    dev = vectors.device
    anchors = torch.from_numpy(r.integers(0, n, P).astype(np.int32)).to(dev)
    if near:
        v = vectors.to(torch.float32)
        d = torch.cdist(v[anchors.long()], v)
        ci = torch.topk(d, C + 1, largest=False).indices[:, 1:].to(
            torch.int32)
    else:
        ci = torch.from_numpy(r.integers(0, n, (P, C)).astype(np.int32)
                              ).to(dev)
    if C > 1:
        ci[:, C // 2] = ci[:, 1]
    ci[torch.from_numpy(r.random((P, C)) < 0.15).to(dev)] = -1
    ci[0] = -1
    ci[1, 5:] = -1
    cd = tbd._row_dist_dense(vectors.to(torch.float32), sq, anchors, ci,
                             metric)
    return ci.contiguous(), cd.to(torch.float32).contiguous()


def _both(ci, cd, vectors, sq, deg, metric, diversify):
    """(kernel rows, twin rows) as numpy, checking one launch and no call
    on the twin."""
    kw = dict(deg=deg, metric=metric, diversify=diversify)
    _reset()
    got = tbuild._diverse_select_dev(ci, cd, vectors, sq, **kw)
    torch.cuda.synchronize()
    assert ds.launches == 1
    assert ds.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    want = tbuild._diverse_select_reference(ci, cd, vectors, sq, **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.cpu().numpy(), want.cpu().numpy()


def _ids(row):
    return set(row[row >= 0].tolist())


def _row_overlap(a, b):
    hits = sum(len(_ids(x) & _ids(y)) for x, y in zip(a, b))
    return hits / max(1, sum(len(_ids(y)) for y in b))


def _hold(got, want, metric):
    assert (got[0] == -1).all()
    if metric == "cosine":
        assert _row_overlap(got, want) >= 0.99
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("D", [7, 50, 65, 128, 300])
@pytest.mark.parametrize("C,deg", WIDTHS)
def test_kernel_equals_twin_on_integer_rows(cuda, C, deg, D, metric,
                                            diversify):
    vectors, sq = _store(D, 3000, D, cuda)
    ci, cd = _batch(C + D, vectors, sq, 96, C, metric)
    got, want = _both(ci, cd, vectors, sq, deg, metric, diversify)
    assert got.shape == (96, min(C, deg))
    _hold(got, want, metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("C,deg", [(256, 32), (1024, 64), (33, 8)])
def test_wide_rows(cuda, C, deg, metric):
    vectors, sq = _store(1, 5000, 128, cuda)
    ci, cd = _batch(2, vectors, sq, 40, C, metric)
    _hold(*_both(ci, cd, vectors, sq, deg, metric, True), metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_reduced_stores(cuda, dtype, metric):
    """The builder's fp16 descent store (descent_dtype="float16") and a
    bf16 store: integer values are exact in both."""
    vectors, sq = _store(3, 3000, 128, cuda, dtype)
    ci, cd = _batch(4, vectors, sq, 128, 96, metric)
    _hold(*_both(ci, cd, vectors, sq, 32, metric, True), metric)


@pytest.mark.parametrize("metric", METRICS)
def test_gaussian_rows_at_the_layer0_shape(cuda, metric):
    """P 2,048, C 96, deg 32, D 128 on each anchor's nearest rows: at
    least 0.999 of the rows equal."""
    vectors, sq = _store(5, 50_000, 128, cuda, gaussian=True)
    ci, cd = _batch(6, vectors, sq, 2048, 96, metric, near=True)
    got, want = _both(ci, cd, vectors, sq, 32, metric, True)
    equal = float(np.mean((got == want).all(axis=1)))
    assert equal >= 0.999, equal
    assert _row_overlap(got, want) >= 0.999


def test_views_and_zero_rows(cuda):
    """A strided view of the candidates is made contiguous; P = 0 launches
    nothing and returns [0, min(C, deg)]."""
    vectors, sq = _store(7, 3000, 64, cuda)
    ci, cd = _batch(8, vectors, sq, 64, 128, "l2")
    got, want = _both(ci[:, ::2], cd[:, ::2], vectors, sq, 32, "l2", True)
    np.testing.assert_array_equal(got, want)
    _reset()
    out = tbuild._diverse_select_dev(ci[:0], cd[:0], vectors, sq, deg=32,
                                     metric="l2", diversify=True)
    assert out.shape == (0, 32) and ds.launches == 0


def test_custom_metric_runs_the_twin_counted_as_mode(cuda):
    register_distance("select_cuda_l1",
                      lambda a, b: float(np.abs(a - b).sum()),
                      pairwise_fn=lambda a, b: torch.cdist(a, b, p=1))
    vectors, sq = _store(9, 3000, 32, cuda)
    ci, cd = _batch(10, vectors, sq, 32, 64, "l2")
    _reset()
    kw = dict(deg=16, metric="select_cuda_l1", diversify=True)
    got = tbuild._diverse_select_dev(ci, cd, vectors, sq, **kw)
    assert ds.launches == 0
    assert ds.plain_on_cuda == {"mode": 1, "size": 0, "other": 0}
    want = tbuild._diverse_select_reference(ci, cd, vectors, sq, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_past_the_width_limit_runs_the_twin_counted_as_size(cuda):
    vectors, sq = _store(11, 3000, 16, cuda)
    ci, cd = _batch(12, vectors, sq, 4, ds.SELECT_MAX_C + 1, "l2")
    _reset()
    tbuild._diverse_select_dev(ci, cd, vectors, sq, deg=32, metric="l2",
                               diversify=True)
    assert ds.launches == 0
    assert ds.plain_on_cuda == {"mode": 0, "size": 1, "other": 0}


def test_builder_functions_launch_the_kernel(cuda):
    """_assemble_wave_rows and _reverse_update(diversify=True) on CUDA:
    one launch each (the reverse update a launch a chunk), the rows of
    the same calls on the CPU (the twin)."""
    r = np.random.default_rng(13)
    n, W, D = 600, 64, 24
    vecs = r.integers(-4, 5, (n, D)).astype(np.float32)
    sq = (vecs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    cand_i = r.integers(0, n - W, (W, 32)).astype(np.int32)
    wslots = np.arange(n - W, n, dtype=np.int32)
    in_layer = np.ones(W, bool)
    intra = r.random((W, W)).astype(np.float32)
    np.fill_diagonal(intra, INF)
    part = np.arange(W, dtype=np.int64)

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            vecs=vecs, sq=sq, cand_i=cand_i, wslots=wslots,
            in_layer=in_layer, intra=intra, part=part).items()}
        rows = tbd._assemble_wave_rows(
            t["vecs"], t["sq"], None, t["cand_i"], t["intra"], t["wslots"],
            t["part"], t["in_layer"], deg=16, n_cand=32, intra_k=16,
            metric="l2", diversify=True)
        nb = torch.full((n, 16), -1, dtype=torch.int32, device=dev)
        tbd._reverse_update(nb, t["vecs"], t["sq"],
                            t["cand_i"][:, 0].contiguous(), t["wslots"],
                            deg=16, metric="l2", diversify=True)
        return rows.cpu().numpy(), nb.cpu().numpy()

    _reset()
    rows_k, nb_k = run(cuda)
    assert ds.launches == 2
    assert ds.plain_on_cuda == {"mode": 0, "size": 0, "other": 0}
    rows_c, nb_c = run("cpu")
    np.testing.assert_array_equal(rows_k, rows_c)
    np.testing.assert_array_equal(nb_k, nb_c)


def test_shared_memory_and_occupancy(cuda):
    """The library's shared layout equals the wrapper's copy
    (``ops/diverse_select.smem_bytes``: six [C] arrays, the triangle of
    conflict bits, the staged bf16 rows); every store's kernel fits an SM
    up to SELECT_MAX_C at every D, and at least 4 blocks an SM at the
    layer-0 call (C 96, D 128, f32)."""
    lib = ds._load()
    for C in (1, 15, 16, 17, 20, 33, 64, 95, 96, 97, 252, 255, 256, 257,
              500, ds.SELECT_MAX_C):
        for D in (1, 7, 50, 65, 128, 300, 960):
            for store in ds.STORES.values():
                got = lib.diverse_select_smem_bytes(C, D, store)
                assert got == ds.smem_bytes(C, D, store) > 0, (C, D, store)
                assert lib.diverse_select_blocks_per_sm(C, D, store) >= 1
    assert lib.diverse_select_smem_bytes(ds.SELECT_MAX_C + 1, 128, 0) == -1
    assert ds.smem_bytes(ds.SELECT_MAX_C + 1, 128, 0) == -1
    assert lib.diverse_select_smem_bytes(96, 128, 3) == -1
    assert lib.diverse_select_blocks_per_sm(96, 128, 3) == -1
    assert lib.diverse_select_blocks_per_sm(96, 128, 0) >= 4
    assert lib.diverse_select_workspace_bytes(2048, 96, 128, 0) == 0
    assert lib.diverse_select_workspace_bytes(64, 1024, 128, 0) > 0


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(ds.STORES))
@pytest.mark.parametrize("C", [1, 15, 16, 17, 33, 95, 96, 97, 255, 256, 257,
                               1024])
def test_candidates_across_the_padding(cuda, C, dtype, metric, diversify):
    """C on both sides of each multiple of 16 and 32, every store, integer
    rows at D 128: the rows equal the twin's (cosine overlap >= 0.99)."""
    vectors, sq = _store(17, 3000, 128, cuda, dtype)
    ci, cd = _batch(C, vectors, sq, 24 if C > 256 else 48, C, metric)
    deg = min(32, max(1, C // 2))
    _hold(*_both(ci, cd, vectors, sq, deg, metric, diversify), metric)


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [7, 50, 65, 128, 300])
def test_widths_in_the_reduced_stores(cuda, D, dtype, metric, diversify):
    """D padded to 16 in the fp16 and bf16 stores (16-byte loads at D % 8
    == 0, else element by element): equal rows at C 96 / deg 32."""
    vectors, sq = _store(D + 1, 3000, D, cuda, dtype)
    ci, cd = _batch(D + 2, vectors, sq, 64, 96, metric)
    _hold(*_both(ci, cd, vectors, sq, 32, metric, diversify), metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(ds.STORES))
@pytest.mark.parametrize("C,D,deg", [(1024, 128, 64), (256, 300, 32)])
def test_the_slab_path(cuda, C, D, deg, dtype, metric):
    """Rows that do not fit the block whole are staged in D slabs (the
    layout says so), accumulators carried in the workspace: equal rows."""
    assert ds.layout(C, D)["n_slabs"] > 1
    vectors, sq = _store(19, 5000, D, cuda, dtype)
    ci, cd = _batch(20, vectors, sq, 40, C, metric)
    _hold(*_both(ci, cd, vectors, sq, deg, metric, True), metric)


@pytest.mark.parametrize("C,D,budget", [(256, 300, 200 * 1024),
                                        (96, 128, 8 * 1024),
                                        (512, 128, 200 * 1024)])
def test_slabs_and_whole_rows_agree(cuda, tmp_path, C, D, budget):
    """The same integer inputs through the shipped library and a build
    whose DIVERSE_SELECT_ROW_BUDGET moves the threshold (whole rows where
    the shipped kernel stages slabs, or slabs where it stages whole rows):
    the same rows, in every store and metric."""
    shipped = ds.layout(C, D)["n_slabs"]
    other = ds.layout(C, D, row_budget=budget)["n_slabs"]
    assert (shipped == 1) != (other == 1), (shipped, other)
    lib = ds.bind(ds.build((f"DIVERSE_SELECT_ROW_BUDGET={budget}",),
                           str(tmp_path)))
    for store in ds.STORES.values():
        assert lib.diverse_select_smem_bytes(C, D, store) == ds.layout(
            C, D, row_budget=budget)["total"]
    for dtype in ds.STORES:
        vectors, sq = _store(21, 4000, D, cuda, dtype)
        for metric in METRICS:
            ci, cd = _batch(22, vectors, sq, 48, C, metric)
            kw = dict(deg=32, metric=metric, diversify=True)
            a = ds.diverse_select_cuda(ci, cd, vectors, sq, **kw)
            saved = ds._lib
            ds._lib = lib
            try:
                b = ds.diverse_select_cuda(ci, cd, vectors, sq, **kw)
            finally:
                ds._lib = saved
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("diversify", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", list(ds.STORES))
@pytest.mark.parametrize("C,D", [(96, 128), (96, 50), (1024, 128)])
def test_ids_past_the_store_read_its_last_row(cuda, C, D, dtype, metric,
                                              diversify):
    """Ids at or past the store's N (up to INT32_MAX): the twin gathers
    row N - 1 for them and keeps the id, and so does the kernel, on every
    path of its gather (16-byte loads, element loads at D 50, cp.async of
    a bf16 store, D in slabs at C 1,024): equal rows."""
    vectors, sq = _store(25, 3000, D, cuda, dtype)
    ci, cd = _batch(26, vectors, sq, 24, C, metric)
    cols = torch.arange(C, device=cuda) % 5 == 2
    past = cols[None, :] & (ci >= 0)
    ci = torch.where(past, 3000 + ci * 7, ci).to(torch.int32).contiguous()
    ci[2, 3] = torch.iinfo(torch.int32).max
    assert int((ci >= 3000).sum()) > 100
    got, want = _both(ci, cd, vectors, sq, 32, metric, diversify)
    assert (want >= 3000).any()
    _hold(got, want, metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_gaussian_rows_in_the_reduced_stores(cuda, dtype, metric):
    """The layer-0 shape on Gaussian rows stored as fp16 or bf16: at least
    0.999 of the rows equal."""
    vectors, sq = _store(23, 50_000, 128, cuda, dtype, gaussian=True)
    ci, cd = _batch(24, vectors, sq, 2048, 96, metric, near=True)
    got, want = _both(ci, cd, vectors, sq, 32, metric, True)
    equal = float(np.mean((got == want).all(axis=1)))
    assert equal >= 0.999, equal


def test_arguments_the_kernel_does_not_take_raise(cuda):
    vectors, sq = _store(14, 100, 16, cuda)
    ci, cd = _batch(15, vectors, sq, 8, 32, "l2")
    with pytest.raises(ValueError):
        ds.diverse_select_cuda(ci, cd[:, :16], vectors, sq, deg=8,
                               metric="l2", diversify=True)
    with pytest.raises(ValueError):
        ds.diverse_select_cuda(ci, cd.cpu(), vectors, sq, deg=8,
                               metric="l2", diversify=True)
