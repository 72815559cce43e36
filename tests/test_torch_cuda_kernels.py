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
