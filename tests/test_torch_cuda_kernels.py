"""The CUDA exact-screen kernel against its plain torch version, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these tests skip where
there is no NVIDIA GPU (decided inside the fixture, never at import).
Run them on a GPU machine with ``python -m pytest tests/test_torch_cuda_kernels.py``.

Both versions screen the same tensors; the pools are then reranked in f32
by the same code. f32: ids equal, distances within 1e-5 (both are
reranked in f32). fast_math: id overlap >= 0.999 (the bf16 screens may
cut their pools at different places), matched distances within 1e-5.
Each case also checks which producer fed the TF32 ``wgmma`` screen
(``launches_by_route``): TMA (``"wgmma"``) where D % 4 == 0 and the rows
are 16-byte aligned, the threads' cp.async copies (``"wgmma_cp"``)
elsewhere.

The capacity screen (the same kernel over the capacity modes' int8, bf16
and fp16 tables, ``capacity_scan``; the int8 and bf16 tables TMA takes
go to its own warp-specialised bf16 kernel, route "bf16_ws", where it
fits) is held to its plain version,
``ops/topk.quantized_topk_candidates``, on the same tensors: id overlap
>= 0.999 and matched distances within 1e-5 of max(1, |d|) (the products
are exact, or within 2^-22 of sum |q_i v_i| for fp16; f32 sums run in
another order; an absolute 1e-5 below |d| = 1, because fp16's 2xTF32
product leaves ~2^-22 of sum |q_i v_i|, which is a larger share of a
small distance), at every store x metric x D in {7, 25, 50, 65, 128} x
kk in {1, 14, 26, 128, 150, 256}, through each producer, on unaligned
views, tables of 1 to 5,000 rows, an all-masked table and zero rows;
its one-tile Gram against float64 within 1e-5 of sum |q_i v_i|; its
launch counts by store (and the plain scans of a CUDA table past kk
256, counted apart); a broken build raises. "bf16_ws" on its own: int8
and bf16 x the four metrics x kk 1 / 26 / 150 / 256 x D 16 / 64 / 128 /
960 (the route where ``ws_applies``, K1's kernel past it), ids equal to
the plain version's on integer-valued data (l2, sqeuclidean, dot: exact
arithmetic on both sides; kk up to its limit, 32), Q 8 and 1,024, an
all-masked table, segment boundaries inside a tile, its one-tile Gram
against float64, and its shared memory against the library's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(device, n, n_valid, nq, d=64, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((n, d), generator=g, device=device)
    q = torch.randn((nq, d), generator=g, device=device)
    valid = torch.zeros(n, dtype=torch.bool, device=device)
    valid[:n_valid] = True
    return q, v, (v * v).sum(-1), valid


def _route(d):
    return "wgmma" if d % 4 == 0 else "wgmma_cp"


def _reset():
    es.launches = 0
    es.launches_by_route.update(wgmma=0, wgmma_cp=0)


def _both(q, v, sq, valid, k, metric, fast, route=None):
    _reset()
    dk, ik = es.exact_topk_fused(q, v, sq, valid, k=k, metric=metric,
                                 fast_math=fast)
    assert es.launches == 1
    assert es.launches_by_route[route or _route(q.shape[1])] == 1
    k_sel = min(k + 8, 128, v.shape[0])
    _, ids = es.exact_screen_reference(q, v, sq, valid, k_sel=k_sel,
                                       metric=metric, fast_math=fast)
    dp, ip = es.rerank_pool(q, v, sq, ids, k=k, metric=metric)
    return dk.cpu().numpy(), ik.cpu().numpy(), dp.cpu().numpy(), \
        ip.cpu().numpy()


def _hold(dk, ik, dp, ip, fast):
    """f32: ids equal; fast_math: id overlap >= 0.999; matched distances
    within 1e-5 either way."""
    if fast:
        hits = sum(len(set(a) & set(b)) for a, b in zip(ik, ip))
        assert hits / ip.size >= 0.999
    else:
        np.testing.assert_array_equal(ik, ip)
    same = ik == ip
    np.testing.assert_allclose(dk[same], dp[same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("n,n_valid,nq,d,seed", [(70_000, 65_000, 300, 64, 0),
                                                 (50_000, 47_000, 128, 128, 7)])
def test_kernel_matches_plain(cuda, metric, fast, n, n_valid, nq, d, seed):
    _hold(*_both(*_case(cuda, n, n_valid, nq, d=d, seed=seed), 10, metric,
                 fast, "wgmma"), fast)


#: (D, metric) of the cp.async producer's cases; at D = 1 the cosine
#: distance of every row is 0 or 2, ties that rounding alone orders, so
#: D = 1 runs the three metrics that order the rows
CP_CASES = [(d, m) for d in (25, 50, 65, 100)
            for m in ("cosine", "l2", "sqeuclidean", "dot")] + [
    (1, m) for m in ("l2", "sqeuclidean", "dot")]


@pytest.mark.parametrize("k", [10, 120])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d,metric", CP_CASES)
def test_cp_route_matches_plain(cuda, monkeypatch, d, metric, fast, k):
    """The cp.async producer against the plain version: ragged N and Q,
    masked rows, k_sel 18 and 128, odd and even D (4- and 8-byte copies),
    and D = 100, which TMA would take, sent down it on purpose."""
    monkeypatch.setattr(es, "screen_route", lambda q, v: "wgmma_cp")
    q, v, sq, valid = _case(cuda, 33_001, 33_001, 77, d=d, seed=d)
    valid[::5] = False
    _hold(*_both(q, v, sq, valid, k, metric, fast, "wgmma_cp"), fast)


@pytest.mark.parametrize("k,d", [(64, 100), (120, 960), (1, 7)])
def test_kernel_ragged_widths(cuda, k, d):
    """Ragged N and Q, D not a multiple of the 32-wide stage, k_sel up to
    the kernel's 128."""
    dk, ik, dp, ip = _both(*_case(cuda, 40_001, 40_001, 37, d=d), k,
                           "l2", False)
    np.testing.assert_array_equal(ik, ip)


def test_kernel_few_valid_rows(cuda):
    dk, ik, dp, ip = _both(*_case(cuda, 5_000, 6, 16), 10, "cosine", False)
    np.testing.assert_array_equal(ik, ip)
    assert np.all(ik[:, 6:] == -1)


def test_kernel_screen_keys_match_plain(cuda):
    q, v, sq, valid = _case(cuda, 9_000, 8_500, 65, seed=3)
    dk, ik = es.exact_screen(q, v, sq, valid, k_sel=20, metric="dot")
    dp, ip = es.exact_screen_reference(q, v, sq, valid, k_sel=20,
                                       metric="dot")
    same = ik == ip
    assert same.float().mean() >= 0.99
    torch.testing.assert_close(dk[same], dp[same], atol=1e-4, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_exact_index_on_card_matches_cpu(cuda, fast):
    """Below 32768 rows ExactIndex scans with plain torch (exact_topk) on
    the card; above, through the kernel. Both must give the CPU's ids;
    distances within 1e-4 (f32 sums in another order, l2 values ~10)."""
    from hnsw_tpu_torch import ExactIndex
    r = np.random.default_rng(5)
    q = r.standard_normal((40, 48)).astype(np.float32)
    for n in (5_000, 40_000):
        v = r.standard_normal((n, 48)).astype(np.float32)
        out = []
        for dev in (cuda, "cpu"):
            idx = ExactIndex(metric="l2", fast_math=fast, device=dev)
            idx.host_serve_max_batch = 0
            idx.batch_add(list(range(n)), v)
            out.append(idx.batch_search_slots(q, 10))
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-4, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, v, sq, valid = _case(cuda, 1_000, 1_000, 4)
    with pytest.raises(ValueError):
        es.exact_screen(q, v, sq, valid, k_sel=129)
    with pytest.raises(TypeError):
        es.exact_screen(q.double(), v, sq, valid, k_sel=8)
    with pytest.raises(ValueError):
        es.exact_screen(q, v.t(), sq, valid, k_sel=8)
    with pytest.raises(ValueError):
        es.exact_screen(q, v.cpu(), sq, valid, k_sel=8)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d,route", [(d, "wgmma") for d in (4, 32, 36, 128)]
                         + [(d, "wgmma_cp") for d in (4, 7, 36, 50, 128)])
def test_wgmma_tile_product_matches_matmul(cuda, monkeypatch, d, route,
                                           fast):
    """One 64 x 128 tile through the TF32 wgmma kernel, fed by TMA or by
    cp.async: with the dot metric and k_sel = N = 128 the screen returns
    every column, so -dist is the kernel's Gram. Held against a float64
    product of the same operands (bf16-rounded for fast_math) within 1e-5
    of sum |q_i v_i|: 3xTF32 drops ~2^-22 of it and f32 sums add ~D 2^-24,
    while one TF32 pass on f32 operands would be off by ~1e-4 and a
    wrong descriptor, swizzle or zero fill by O(1)."""
    q, v, sq, valid = _case(cuda, 128, 128, 64, d=d, seed=d)
    monkeypatch.setattr(es, "screen_route", lambda q, v: route)
    _reset()
    dist, ids = es.exact_screen(q, v, sq, valid, k_sel=128, metric="dot",
                                fast_math=fast)
    assert es.launches_by_route[route] == 1
    assert (torch.sort(ids, dim=1).values
            == torch.arange(128, device=cuda)).all()
    gram = torch.empty_like(dist).scatter_(1, ids, -dist)
    qq, vv = q.double(), v.double()
    if fast:
        qq, vv = q.bfloat16().double(), v.bfloat16().double()
    want = qq @ vv.T
    scale = qq.abs() @ vv.abs().T
    err = ((gram.double() - want).abs() / scale).max().item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("nq", [1, 37])
def test_wgmma_small_batches(cuda, nq):
    dk, ik, dp, ip = _both(*_case(cuda, 33_000, 33_000, nq, d=128), 10,
                           "l2", False, "wgmma")
    np.testing.assert_array_equal(ik, ip)


def test_k_sel_128_at_d960_screen_keys(cuda):
    """The shared-memory budget case: k_sel = 128 key lists beside the
    ring at D = 960 (30 stages a tile)."""
    q, v, sq, valid = _case(cuda, 6_000, 6_000, 70, d=960, seed=9)
    _reset()
    dk, ik = es.exact_screen(q, v, sq, valid, k_sel=128, metric="l2")
    assert es.launches_by_route["wgmma"] == 1
    dp, ip = es.exact_screen_reference(q, v, sq, valid, k_sel=128,
                                       metric="l2")
    assert (ik == ip).float().mean() >= 0.99
    torch.testing.assert_close(dk, dp, atol=1e-3, rtol=0)


@pytest.mark.parametrize("seg_len", [1000, 4_321])
def test_segment_boundary_inside_a_tile(cuda, monkeypatch, seg_len):
    """N = 20,001 (not a multiple of the 128-column tile) cut into
    segments whose ends fall inside a tile: the rows TMA loads past a
    segment's end belong to the next segment and are masked."""
    q, v, sq, valid = _case(cuda, 20_001, 19_000, 70, d=128, seed=11)
    monkeypatch.setattr(es, "_plan_segments",
                        lambda *a: (-(-v.shape[0] // seg_len), seg_len))
    for fast in (False, True):
        dk, ik, dp, ip = _both(q, v, sq, valid, 10, "cosine", fast,
                               "wgmma")
        if not fast:
            np.testing.assert_array_equal(ik, ip)
        same = ik == ip
        assert same.mean() >= 0.99
        np.testing.assert_allclose(dk[same], dp[same], atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [7, 50, 128])
def test_misaligned_or_odd_rows_take_the_cp_route(cuda, d):
    """A table whose base pointer is 4 bytes past 16-byte alignment (4-byte
    copies even at an even D), and D = 7 (a row of 28 bytes), cannot be
    TMA-copied: the cp.async producer runs and gives the plain version's
    ids."""
    n = 30_000
    g = torch.Generator(device=cuda).manual_seed(d)
    v = torch.randn(n * d + 1, generator=g, device=cuda)[1:].view(n, d)
    q = torch.randn((50, d), generator=g, device=cuda)
    assert es.screen_route(q, v) == "wgmma_cp"
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    dk, ik, dp, ip = _both(q, v, (v * v).sum(-1), valid, 10, "l2", False,
                           "wgmma_cp")
    np.testing.assert_array_equal(ik, ip)


def test_wrapper_raises_when_the_library_fails_to_load(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed (1): simulated")
    q, v, sq, valid = _case(cuda, 1_000, 1_000, 4)
    monkeypatch.setattr(es, "_lib", None)
    monkeypatch.setattr(es, "build", broken)
    _reset()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        es.exact_screen(q, v, sq, valid, k_sel=8)
    assert es.launches == 0


# ---- the capacity screen (K3's port): int8 with per-row scales, bf16, fp16

CAP_STORES = ["int8", "bf16", "fp16"]


def _cap_reset():
    es.launches = es.capacity_launches = es.capacity_plain_on_cuda = 0
    es.launches_by_route.update(wgmma=0, wgmma_cp=0)
    es.capacity_launches_by_store.update(int8=0, bf16=0, fp16=0)
    es.capacity_launches_by_route.update(wgmma=0, wgmma_ld=0, bf16_ws=0)


def _cap_table(v, store):
    """The capacity modes' table of f32 rows ``v``: ExactIndex's per-row
    int8 quantisation (a zero row gets scale 1), or a bf16 / fp16 cast."""
    if store == "int8":
        amax = v.abs().amax(dim=1)
        s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        t = torch.clamp(torch.round(v / s[:, None]), -127, 127)
        return t.to(torch.int8), s
    return v.to({"bf16": torch.bfloat16, "fp16": torch.float16}[store]), None


def _cap_hold(dk, ik, dp, ip):
    """Id overlap >= 0.999; matched distances within 1e-5 of max(1, |d|)
    (products exact or within 2^-22 of sum |q_i v_i|, f32 sums in
    another order: near-zero distances are held absolutely)."""
    ik, ip = ik.cpu().numpy(), ip.cpu().numpy()
    dk, dp = dk.cpu().numpy(), dp.cpu().numpy()
    assert ik.shape == ip.shape
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(ik, ip))
    assert hits >= 0.999 * max(1, int((ip >= 0).sum()))
    assert np.array_equal(ik < 0, ip < 0)
    same = (ik == ip) & (ik >= 0)
    assert np.all(np.abs(dk[same] - dp[same])
                  <= 1e-5 * np.maximum(1.0, np.abs(dp[same])))
    assert np.all(dk[ik < 0] == es.INF_DIST)


def _cap_case(device, store, n, d, nq=77, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((n, d), generator=g, device=device)
    q = torch.randn((nq, d), generator=g, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    valid[::5] = False
    t, s = _cap_table(v, store)
    return q, t, s, (v * v).sum(-1), valid


@pytest.mark.parametrize("kk", [1, 14, 26, 128, 150, 256])
@pytest.mark.parametrize("d", [7, 25, 50, 65, 128])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("store", CAP_STORES)
def test_capacity_screen_matches_plain(cuda, store, metric, d, kk):
    """capacity_scan on a CUDA table of 33,001 rows (not a multiple of the
    128-column tile, every 5th masked) launches the screen once, on the
    producer its pitch gives, and agrees with the plain version (kk 150:
    the int8 rung's pool at k = 100; 256: the screen's limit)."""
    q, t, s, sq, valid = _cap_case(cuda, store, 33_001, d, seed=d + kk)
    assert es.capacity_applies(33_001, kk, metric, t, s)
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=kk, metric=metric)
    assert es.capacity_launches_by_store[store] == 1
    assert es.capacity_launches == 1 and es.launches == 0
    assert es.capacity_plain_on_cuda == 0
    dp, ip = es.quantized_topk_candidates(q, t, s, sq, valid, kk=kk,
                                          metric=metric)
    _cap_hold(dk, ik, dp, ip)
    assert not torch.isin(ik, torch.arange(0, 33_001, 5,
                                           device=cuda)).any()


@pytest.mark.parametrize("route", ["wgmma", "wgmma_ld"])
@pytest.mark.parametrize("store", CAP_STORES)
def test_capacity_screen_every_producer_at_d128(cuda, monkeypatch, store,
                                                route):
    """The same table through each producer (TMA, ordinary loads): each
    agrees with the plain version."""
    q, t, s, sq, valid = _cap_case(cuda, store, 40_000, 128, seed=5)
    assert es.capacity_route(q, t, 26) == ("wgmma" if store == "fp16"
                                           else "bf16_ws")
    monkeypatch.setattr(es, "capacity_route", lambda q, t, kk: route)
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=26, metric="l2")
    assert es.capacity_launches_by_store[store] == 1
    _cap_hold(dk, ik, *es.quantized_topk_candidates(q, t, s, sq, valid,
                                                    kk=26, metric="l2"))


@pytest.mark.parametrize("store,off,route", [
    ("int8", 4, "wgmma_ld"), ("int8", 1, "wgmma_ld"), ("int8", 3, "wgmma_ld"),
    ("bf16", 4, "wgmma_ld"), ("bf16", 2, "wgmma_ld"), ("fp16", 8, "wgmma_ld"),
    ("fp16", 6, "wgmma_ld")])
def test_capacity_screen_unaligned_row_views(cuda, store, off, route):
    """A D = 64 table whose base lies ``off`` bytes past 16-byte
    alignment takes the ordinary loads."""
    n, d = 35_000, 64
    q, t, s, sq, valid = _cap_case(cuda, store, n, d, seed=off)
    size = t.element_size()
    buf = torch.empty(n * d + 64, dtype=t.dtype, device=cuda)
    skip = ((-buf.data_ptr()) % 16 + off) // size
    view = buf[skip:skip + n * d].view(n, d)
    view.copy_(t)
    assert view.data_ptr() % 16 == off
    assert es.capacity_route(q, view, 14) == route
    _cap_reset()
    dk, ik = es.capacity_scan(q, view, s, sq, valid, kk=14, metric="cosine")
    assert es.capacity_launches_by_store[store] == 1
    _cap_hold(dk, ik, *es.quantized_topk_candidates(q, t, s, sq, valid,
                                                    kk=14, metric="cosine"))


@pytest.mark.parametrize("store", CAP_STORES)
def test_capacity_screen_all_masked_and_zero_rows(cuda, store):
    """An all-masked table gives (INF_DIST, -1) in every slot; zero rows
    (int8 scale 1.0) score as the plain version scores them, and are the
    nearest rows of a near-zero query under l2."""
    q, t, s, sq, valid = _cap_case(cuda, store, 33_000, 32, nq=40, seed=9)
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, torch.zeros_like(valid), kk=26,
                              metric="l2")
    assert (ik == -1).all() and (dk == es.INF_DIST).all()
    assert es.capacity_launches_by_store[store] == 1
    v = torch.randn((33_000, 32), generator=torch.Generator(
        device=cuda).manual_seed(10), device=cuda)
    v[[7, 1000, 32_999]] = 0.0
    t, s = _cap_table(v, store)
    if s is not None:
        assert (s[[7, 1000, 32_999]] == 1.0).all()
    q[0] = 1e-3
    valid = torch.ones(33_000, dtype=torch.bool, device=cuda)
    for metric in ("l2", "cosine", "dot"):
        dk, ik = es.capacity_scan(q, t, s, (v * v).sum(-1), valid, kk=26,
                                  metric=metric)
        dp, ip = es.quantized_topk_candidates(q, t, s, (v * v).sum(-1),
                                              valid, kk=26, metric=metric)
        _cap_hold(dk, ik, dp, ip)
        if metric == "l2":
            assert sorted(ik[0, :3].tolist()) == [7, 1000, 32_999]


@pytest.mark.parametrize("route,d", [("wgmma", 32), ("wgmma", 128),
                                     ("wgmma_ld", 4), ("wgmma_ld", 36),
                                     ("wgmma_ld", 7), ("wgmma_ld", 50)])
@pytest.mark.parametrize("store", CAP_STORES)
def test_capacity_tile_product_matches_float64(cuda, store, route, d):
    """One 64 x 128 tile with the dot metric and kk = N = 128 returns every
    column, so -dist is the kernel's (scaled) Gram. Held against a float64
    product of the operands it should multiply (the bf16-rounded query and
    the int8 rows times their scale, the bf16 rows; the f32 query and the
    fp16 rows) within 1e-5 of sum |q_i v_i|: the int8 and bf16 products
    are exact, fp16's 2xTF32 drops ~2^-22 and f32 sums add ~D 2^-24,
    while a wrong swizzle, widening or zero fill is off by O(1) and a
    dropped lo pass by ~2^-11."""
    q, t, s, sq, valid = _cap_case(cuda, store, 128, d, nq=64, seed=d)
    valid[:] = True
    _cap_reset()
    dist, ids = es._capacity_cuda(q, t, s, sq, valid, 128, "dot", route)
    assert es.capacity_launches_by_store[store] == 1
    assert (torch.sort(ids, dim=1).values
            == torch.arange(128, device=cuda)).all()
    gram = torch.empty_like(dist).scatter_(1, ids, -dist).double()
    vv = t.double() * (s.double()[:, None] if s is not None else 1.0)
    qq = q.double() if store == "fp16" else q.bfloat16().double()
    want = qq @ vv.T
    scale = qq.abs() @ vv.abs().T
    err = ((gram - want).abs() / scale).max().item()
    assert err <= 1e-5, err


def test_capacity_launches_count_by_store_apart_from_k1(cuda):
    """Each capacity_scan that takes the kernel adds one to its store's
    count and to capacity_launches, never to K1's counts; past kk 256 the
    plain version runs, counted in capacity_plain_on_cuda only."""
    _cap_reset()
    want = {"int8": 0, "bf16": 0, "fp16": 0}
    for store, reps in (("int8", 2), ("bf16", 1), ("fp16", 3)):
        q, t, s, sq, valid = _cap_case(cuda, store, 32_768, 16, nq=8)
        for _ in range(reps):
            es.capacity_scan(q, t, s, sq, valid, kk=14, metric="l2")
        want[store] += reps
        es.capacity_scan(q, t, s, sq, valid, kk=257, metric="l2")
        assert es.capacity_launches_by_store == want
    assert es.capacity_launches == 6 and es.capacity_plain_on_cuda == 3
    assert es.launches == 0 and es.launches_by_route == {"wgmma": 0,
                                                         "wgmma_cp": 0}


@pytest.mark.parametrize("n", [1, 30, 128, 1000, 5000])
@pytest.mark.parametrize("store", CAP_STORES)
def test_capacity_screen_small_tables(cuda, store, n):
    """There is no row switch: a table of any size takes the screen, and
    a kk past N gives N candidates, as the plain version does."""
    q, t, s, sq, valid = _cap_case(cuda, store, n, 48, nq=70, seed=n)
    valid = torch.ones_like(valid)
    valid[3::5] = False                   # row 0 stays valid at N = 1
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=150, metric="l2")
    assert es.capacity_launches_by_store[store] == 1
    assert es.capacity_plain_on_cuda == 0
    dp, ip = es.quantized_topk_candidates(q, t, s, sq, valid, kk=150,
                                          metric="l2")
    assert ik.shape == ip.shape == (70, min(n, 150))
    _cap_hold(dk, ik, dp, ip)


def test_capacity_scan_raises_on_a_broken_build(cuda, monkeypatch):
    """A build that fails raises from capacity_scan; the plain scan is not
    run in its place and no launch is counted."""
    def broken():
        raise RuntimeError("nvcc failed (1): simulated")
    q, t, s, sq, valid = _cap_case(cuda, "int8", 33_000, 32, nq=4)
    monkeypatch.setattr(es, "_lib", None)
    monkeypatch.setattr(es, "build", broken)
    monkeypatch.setattr(es, "quantized_topk_candidates",
                        lambda *a, **kw: pytest.fail("the plain scan ran"))
    _cap_reset()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        es.capacity_scan(q, t, s, sq, valid, kk=26, metric="l2")
    assert es.capacity_launches == 0


@pytest.mark.parametrize("store", CAP_STORES)
def test_exact_index_capacity_rung_on_card_matches_cpu(cuda, store):
    """ExactIndex's capacity rung at 40,000 rows takes the screen on the
    card; after the host rerank its ids equal the CPU's (the plain scan),
    distances within 1e-5 (both reranked by the same numpy code)."""
    from hnsw_tpu_torch import ExactIndex
    r = np.random.default_rng(11)
    v = r.standard_normal((40_000, 48)).astype(np.float32)
    q = r.standard_normal((30, 48)).astype(np.float32)
    out = []
    for dev in (cuda, "cpu"):
        idx = ExactIndex(metric="l2", hbm_dtype=store, device=dev)
        idx.host_serve_max_batch = 0
        idx.batch_add(list(range(len(v))), v)
        _cap_reset()
        out.append(idx.batch_search_slots(q, 10))
        assert es.capacity_launches_by_store[store] == (dev == cuda)
    hits = sum(len(set(a) & set(b)) for a, b in zip(out[0][1], out[1][1]))
    assert hits >= 0.999 * out[1][1].size
    same = out[0][1] == out[1][1]
    np.testing.assert_allclose(out[0][0][same], out[1][0][same], atol=1e-5,
                               rtol=0)


# ---- the capacity screen's warp-specialised bf16 route ("bf16_ws")

WS_STORES = ["int8", "bf16"]


def _ws_want(d, kk, store):
    return "bf16_ws" if es.ws_applies(d, kk, store) else "wgmma"


@pytest.mark.parametrize("d", [16, 64, 128, 960])
@pytest.mark.parametrize("kk", [1, 26, 150, 256])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("store", WS_STORES)
def test_ws_route_matches_plain(cuda, store, metric, kk, d):
    """capacity_scan of a ragged table (20,011 rows: no multiple of the
    64-row tile; every 7th masked) takes "bf16_ws" where its lists fit a
    warp's registers and its block shared memory (kk 150 / 256 and D =
    960 keep K1's kernel) and agrees with the plain version: id overlap
    >= 0.999, matched distances within 1e-5 of max(1, |d|)."""
    n = 20_011
    q, t, s, sq, valid = _cap_case(cuda, store, n, d, seed=3 * d + kk)
    valid = torch.ones_like(valid)
    valid[::7] = False
    route = _ws_want(d, kk, store)
    assert es.capacity_route(q, t, kk) == route
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=kk, metric=metric)
    assert es.capacity_launches_by_route == dict(
        {"wgmma": 0, "wgmma_ld": 0, "bf16_ws": 0}, **{route: 1})
    assert es.capacity_launches_by_store[store] == 1
    assert es.capacity_plain_on_cuda == 0
    dp, ip = es.quantized_topk_candidates(q, t, s, sq, valid, kk=kk,
                                          metric=metric)
    _cap_hold(dk, ik, dp, ip)
    assert not torch.isin(ik, torch.arange(0, n, 7, device=cuda)).any()


def _int_case(device, store, n, d, nq, seed):
    """Integer-valued rows and queries in [-3, 3] (exact in int8 with
    scale 1 and in bf16; every product and sum exact in f32), a tenth of
    the rows copies of others (equal distances: ties to the lower id)."""
    r = np.random.default_rng(seed)
    v = r.integers(-3, 4, (n, d)).astype(np.float32)
    v[r.integers(0, n, n // 10)] = v[r.integers(0, n, n // 10)]
    q = r.integers(-3, 4, (nq, d)).astype(np.float32)
    vt = torch.from_numpy(v).to(device)
    if store == "int8":
        t, s = vt.to(torch.int8), torch.ones(n, device=device)
    else:
        t, s = vt.to(torch.bfloat16), None
    valid = torch.ones(n, dtype=torch.bool, device=device)
    return (torch.from_numpy(q).to(device), t, s, (vt * vt).sum(-1), valid)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("kk", [1, 26, 32])
@pytest.mark.parametrize("metric", ["cosine", "l2", "sqeuclidean", "dot"])
@pytest.mark.parametrize("store", WS_STORES)
def test_ws_route_equal_ids_on_integer_data(cuda, store, metric, kk, d):
    """On integer data both versions compute the same exact distances, so
    the ids are equal, ties to the lower id (l2, sqeuclidean, dot); cosine
    rounds its rsqrt on either side and is held as the other cases are."""
    q, t, s, sq, valid = _int_case(cuda, store, 9_999, d, 70, seed=d + kk)
    assert es.capacity_route(q, t, kk) == "bf16_ws"
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=kk, metric=metric)
    assert es.capacity_launches_by_route["bf16_ws"] == 1
    dp, ip = es.quantized_topk_candidates(q, t, s, sq, valid, kk=kk,
                                          metric=metric)
    if metric == "cosine":
        _cap_hold(dk, ik, dp, ip)
    else:
        assert torch.equal(ik, ip)
        assert torch.equal(dk, dp)


@pytest.mark.parametrize("nq", [8, 1024])
@pytest.mark.parametrize("store", WS_STORES)
def test_ws_route_query_batches(cuda, store, nq):
    """Q = 8 (one block, three of its four consumers past Q) and Q = 1,024
    (four blocks a segment) at the SIFT1M width, 50,000 rows."""
    q, t, s, sq, valid = _cap_case(cuda, store, 50_000, 128, nq=nq,
                                   seed=nq)
    kk = {"int8": 26, "bf16": 14}[store]
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, valid, kk=kk, metric="l2")
    assert es.capacity_launches_by_route["bf16_ws"] == 1
    _cap_hold(dk, ik, *es.quantized_topk_candidates(q, t, s, sq, valid,
                                                    kk=kk, metric="l2"))


@pytest.mark.parametrize("store", WS_STORES)
def test_ws_route_all_masked(cuda, store):
    q, t, s, sq, valid = _cap_case(cuda, store, 10_000, 64, nq=33, seed=2)
    _cap_reset()
    dk, ik = es.capacity_scan(q, t, s, sq, torch.zeros_like(valid), kk=26,
                              metric="cosine")
    assert es.capacity_launches_by_route["bf16_ws"] == 1
    assert (ik == -1).all() and (dk == es.INF_DIST).all()


@pytest.mark.parametrize("seg_len", [37, 100, 1000])
@pytest.mark.parametrize("store", WS_STORES)
def test_ws_route_segment_boundary_inside_a_tile(cuda, store, seg_len):
    """Segments of 37 / 100 / 1,000 rows end inside a 64-row tile (the
    tile's rows past the segment are masked; the next segment scores
    them), as a plan of whole tiles never does."""
    n = 3_001
    q, t, s, sq, valid = _cap_case(cuda, store, n, 64, nq=70, seed=seg_len)
    plan = (-(-n // seg_len), seg_len)
    kk = 14 if plan[0] * 26 > 4096 else 26
    _cap_reset()
    dk, ik = es._capacity_cuda(q, t, s, sq, valid, kk, "l2", "bf16_ws",
                               plan=plan)
    assert es.capacity_launches_by_route["bf16_ws"] == 1
    _cap_hold(dk, ik, *es.quantized_topk_candidates(q, t, s, sq, valid,
                                                    kk=kk, metric="l2"))


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("store", WS_STORES)
def test_ws_tile_product_matches_float64(cuda, store, d):
    """One 32-row table with the dot metric and kk = N = 32 returns every
    column, so -dist is the kernel's scaled Gram: held to a float64
    product of the bf16-rounded query and the int8 rows times their
    scale, or the bf16 rows, within 1e-5 of sum |q_i v_i| (the products
    are exact; a wrong swizzle, widening or zero fill is off by O(1))."""
    q, t, s, sq, valid = _cap_case(cuda, store, 32, d, nq=64, seed=d)
    valid[:] = True
    _cap_reset()
    dist, ids = es._capacity_cuda(q, t, s, sq, valid, 32, "dot", "bf16_ws")
    assert es.capacity_launches_by_route["bf16_ws"] == 1
    assert (torch.sort(ids, dim=1).values
            == torch.arange(32, device=cuda)).all()
    gram = torch.empty_like(dist).scatter_(1, ids, -dist).double()
    vv = t.double() * (s.double()[:, None] if s is not None else 1.0)
    qq = q.bfloat16().double()
    err = ((gram - qq @ vv.T).abs() / (qq.abs() @ vv.abs().T)).max().item()
    assert err <= 1e-5, err


def test_ws_smem_bytes_match_the_library(cuda):
    """The wrapper's ws_smem_bytes is the library's, and a block fits an
    SM exactly where ws_applies says so (kk <= 32, D <= 192)."""
    lib = es._load()
    for store in WS_STORES:
        for d in (16, 64, 128, 192, 256):
            for kk in (1, 14, 26, 32, 33, 40, 150):
                nbytes = lib.exact_screen_smem_bytes(4, d, kk,
                                                     es.STORES[store])
                assert nbytes == es.ws_smem_bytes(d, store)
                per_sm = lib.exact_screen_blocks_per_sm(4, d, kk,
                                                        es.STORES[store])
                assert (per_sm >= 1) == es.ws_applies(d, kk, store), (
                    store, d, kk, per_sm)
    assert lib.exact_screen_blocks_per_sm(4, 128, 14, 4) < 0   # fp16
