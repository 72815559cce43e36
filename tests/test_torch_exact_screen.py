"""The fused exact screen (K1) of hnsw_tpu_torch against hnsw_tpu's.

On the CPU the port's ``exact_topk_fused`` runs its plain torch screen;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does. The port's int64 keys differ from the TPU's
packed int32 keys on purpose, so the two are held equal after the f32
rerank: ids equal and distances within 1e-5 (f32 sums in another
order). With fast_math both round the Gram operands to bf16, but at other
places in the two frameworks, so the pools may be cut at different
places: id overlap >= 0.999, matched distances within 1e-5.

The CUDA screen (both producers) cannot run here, so its arithmetic is
emulated below (``cvt.rna.tf32.f32`` in torch) and held to the same
contract: 3xTF32 Gram products within 1e-6 of the f32 Gram relative to
sum |q_i v_i| and the same reranked ids as JAX, and a bf16-rounded value
exact in TF32, so one TF32 pass is the fast_math product.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.ops.pallas_exact import exact_topk_fused as jax_fused  # noqa
from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402
from hnsw_tpu_torch.ops.distance import _epilogue, bf16_round  # noqa: E402
from hnsw_tpu_torch.ops.topk import topk_smallest  # noqa: E402

METRICS = ["cosine", "l2", "sqeuclidean", "dot"]


def _data(seed, n, d=32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)


def _both(q, v, valid, k, metric, fast):
    sq = np.sum(v * v, axis=1).astype(np.float32)
    jd, ji = jax_fused(q, v, jnp.asarray(sq), jnp.asarray(valid), k=k,
                       metric=metric, interpret=True, fast_math=fast)
    td, ti = es.exact_topk_fused(torch.from_numpy(q), torch.from_numpy(v),
                                 torch.from_numpy(sq),
                                 torch.from_numpy(valid), k=k,
                                 metric=metric, fast_math=fast)
    return (np.asarray(jd), np.asarray(ji, np.int64), td.numpy(),
            ti.numpy())


def _check(jd, ji, td, ti, fast):
    assert td.shape == jd.shape and ti.shape == ji.shape
    if not fast:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, atol=1e-5, rtol=0)
        return
    hits = total = 0
    for dj, ij, dt, it in zip(jd, ji, td, ti):
        pos = {int(x): p for p, x in enumerate(it) if x >= 0}
        total += int((ij >= 0).sum())
        for p, x in enumerate(ij):
            if x >= 0 and int(x) in pos:
                hits += 1
                assert abs(dt[pos[int(x)]] - dj[p]) <= 1e-5
    assert hits / total >= 0.999


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_matches_jax(metric, fast):
    v, q = _data(1, 2500), _data(2, 40)
    _check(*_both(q, v, np.ones(2500, bool), 10, metric, fast), fast)


@pytest.mark.parametrize("fast", [False, True])
def test_fused_validity_mask_matches_jax(fast):
    v, q = _data(3, 1500), _data(4, 24)
    valid = np.ones(1500, bool)
    valid[::3] = False
    jd, ji, td, ti = _both(q, v, valid, 10, "l2", fast)
    _check(jd, ji, td, ti, fast)
    assert np.all(valid[ti[ti >= 0]])


def test_fused_k_exceeds_valid_count_matches_jax():
    v, q = _data(5, 300), _data(6, 5)
    valid = np.zeros(300, bool)
    valid[[3, 77, 150]] = True
    jd, ji, td, ti = _both(q, v, valid, 8, "cosine", False)
    _check(jd, ji, td, ti, False)
    assert np.all(ti[:, 3:] == -1) and np.all(td[:, 3:] >= es.INF_DIST)
    assert all(set(r[:3].tolist()) == {3, 77, 150} for r in ti)


def test_fused_k64_matches_jax():
    v, q = _data(7, 2500), _data(8, 40)
    _check(*_both(q, v, np.ones(2500, bool), 64, "sqeuclidean", False),
           False)


def test_fused_ragged_q_and_n_matches_jax():
    v, q = _data(9, 1111, 24), _data(10, 13, 24)
    _check(*_both(q, v, np.ones(1111, bool), 10, "dot", False), False)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("d", [7, 25, 50, 65])
def test_fused_odd_widths_match_jax(d, fast):
    """The widths that take the CUDA screen's cp.async producer (D % 4 !=
    0: GloVe's 25 and 50, lastfm's 65), through the same contract."""
    v, q = _data(20 + d, 2000, d), _data(21 + d, 33, d)
    valid = np.ones(2000, bool)
    valid[::9] = False
    _check(*_both(q, v, valid, 10, "cosine", fast), fast)


def _pack(d: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The kernel's key (csrc/exact_screen.cu pack_key), in numpy."""
    u = d.astype(np.float32).view(np.int32).astype(np.int64)
    m = np.where(u >= 0, u, -(1 << 31) - u)
    return (m << 32) | ids.astype(np.int64)


def test_keys_order_by_distance_then_id_and_decode():
    r = np.random.default_rng(11)
    d = np.concatenate([r.standard_normal(200).astype(np.float32),
                        np.float32([0.0, -0.0, 1.5, 1.5, -2.0, -2.0])])
    ids = np.arange(len(d))
    keys = _pack(d, ids)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(order, np.lexsort((ids, d)))
    keys_t = torch.from_numpy(np.append(keys, es._EMPTY_KEY))
    dd, ii = es._decode(keys_t)
    np.testing.assert_array_equal(ii.numpy()[:-1], ids)
    np.testing.assert_array_equal(np.abs(dd.numpy()[:-1]), np.abs(d))
    assert ii[-1] == -1 and dd[-1] >= es.INF_DIST


def test_screen_reference_breaks_ties_to_lower_id():
    v = np.repeat(_data(12, 4), 5, axis=0)          # rows 5i..5i+4 equal
    q = v[[0, 7]] + 0.01
    sq = np.sum(v * v, axis=1)
    valid = np.ones(len(v), bool)
    d, i = es.exact_screen_reference(
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(sq),
        torch.from_numpy(valid), k_sel=7, metric="l2")
    d, i = d.numpy(), i.numpy()
    assert np.all(np.diff(d, axis=1) >= 0)
    for row_d, row_i in zip(d, i):
        for a in range(6):
            if row_d[a] == row_d[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_screen_dispatch_and_limits():
    v, q = _data(13, 64), _data(14, 3)
    sq = torch.from_numpy(np.sum(v * v, axis=1))
    valid = torch.ones(64, dtype=torch.bool)
    es.launches = 0
    d, i = es.exact_screen(torch.from_numpy(q), torch.from_numpy(v), sq,
                           valid, k_sel=5, metric="cosine")
    assert es.launches == 0                  # CPU tensors: plain version
    assert d.shape == (3, 5) and i.dtype == torch.int64
    with pytest.raises(ValueError):
        es.exact_topk_fused(torch.from_numpy(q), torch.from_numpy(v), sq,
                            valid, k=121)


def _view_off_16(n: int, d: int, off: int) -> torch.Tensor:
    """An [n, d] float32 view whose base pointer is ``off`` bytes past
    16-byte alignment."""
    buf = torch.zeros(n * d + 8)
    skip = (-buf.data_ptr() % 16 + off) // 4
    return buf[skip:skip + n * d].view(n, d)


@pytest.mark.parametrize("d,off,want", [
    (1, 0, "wgmma_cp"), (7, 0, "wgmma_cp"), (25, 0, "wgmma_cp"),
    (50, 0, "wgmma_cp"), (65, 0, "wgmma_cp"), (128, 4, "wgmma_cp"),
    (128, 0, "wgmma")])
def test_screen_route_takes_the_tensor_cores_for_every_table(d, off, want):
    """TMA takes D % 4 == 0 at 16-byte aligned pointers; every other f32
    table (any D, any 4-byte offset) takes the cp.async producer, and
    both feed the tensor-core kernel: there is no third route."""
    v = _view_off_16(300, d, off)
    q = _view_off_16(5, d, 0)
    assert v.data_ptr() % 16 == off and q.data_ptr() % 16 == 0
    assert es.screen_route(q, v) == want
    assert es.screen_route(v[:5], q) == want
    assert set(es.ROUTES) == set(es.launches_by_route) == {"wgmma",
                                                           "wgmma_cp"}


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite f32: round to nearest at the low 13
    mantissa bits, ties away from zero (adding half a kept ulp to the
    sign-magnitude bits rounds the magnitude up at a tie)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _gram_3xtf32(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The wgmma route's f32 Gram: hi = tf32(x), lo = tf32(x - hi) for
    both operands, hi*lo + lo*hi + hi*hi; the products are exact in f32
    and summed here in float64."""
    qh, vh = _tf32_rna(q), _tf32_rna(v)
    ql, vl = _tf32_rna(q - qh), _tf32_rna(v - vh)
    qh, ql, vh, vl = (t.double() for t in (qh, ql, vh, vl))
    return qh @ vl.T + ql @ vh.T + qh @ vh.T


def test_tf32_rna_emulation_rounds_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0,
                         -0.0], dtype=torch.float32)
    got = _tf32_rna(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    r = torch.from_numpy(_data(15, 500, 64))
    assert ((_tf32_rna(r).view(torch.int32) & 0x1FFF) == 0).all()
    assert ((_tf32_rna(r) - r).abs() <= r.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("d", [32, 24])
def test_3xtf32_gram_within_1e6_of_f32(d):
    """On the JAX test inputs: |gram_3xtf32 - f32 Gram| <= 1e-6 of
    sum |q_i v_i| (not of the Gram, which may cancel to near zero); the
    f32 Gram is the float64 product rounded once."""
    v = torch.from_numpy(_data(1, 2500, d))
    q = torch.from_numpy(_data(2, 40, d))
    g3 = _gram_3xtf32(q, v).float().double()
    g32 = (q.double() @ v.double().T).float().double()
    scale = q.double().abs() @ v.double().abs().T
    assert ((g3 - g32).abs() / scale).max().item() <= 1e-6


@pytest.mark.parametrize("metric", METRICS)
def test_3xtf32_screen_then_f32_rerank_matches_jax(metric):
    """Screening with the emulated 3xTF32 Gram (the kernel's epilogue,
    mask and k_sel = k + 8 pool) and reranking in f32 gives JAX's fused
    ids; distances within 1e-5 (f32 sums in another order)."""
    v, q = _data(1, 2500), _data(2, 40)
    valid = np.ones(2500, bool)
    valid[::7] = False
    k = 10
    sq = np.sum(v * v, axis=1).astype(np.float32)
    jd, ji = jax_fused(q, v, jnp.asarray(sq), jnp.asarray(valid), k=k,
                       metric=metric, interpret=True)
    tq, tv, tsq = (torch.from_numpy(x) for x in (q, v, sq))
    d = _epilogue(metric, _gram_3xtf32(tq, tv).float(),
                  torch.sum(tq * tq, dim=-1), tsq)
    d = torch.where(torch.from_numpy(valid)[None, :], d, float(es.INF_DIST))
    _, ids = topk_smallest(d, k + 8)
    td, ti = es.rerank_pool(tq, tv, tsq, ids, k=k, metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji, np.int64))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=0)


def test_bf16_values_are_exact_in_tf32():
    """fast_math rounds both operands to bf16 (8 significand bits); TF32
    keeps 11, so tf32(bf16(x)) == bf16(x) bit for bit and one TF32 pass
    gives exactly the bf16 x bf16 -> f32 products fast_math means."""
    r = np.random.default_rng(16)
    x = torch.from_numpy(np.concatenate([
        _data(17, 400, 64).ravel(),
        (r.standard_normal(4096) * 10.0 ** r.integers(-30, 30, 4096))
        .astype(np.float32)]))
    b = bf16_round(x)
    assert torch.equal(_tf32_rna(b).view(torch.int32), b.view(torch.int32))
    assert not torch.equal(_tf32_rna(x), x)      # f32 values are not


def test_screen_split_tool_guards_three_parts_of_the_wgmma_kernel(
        tmp_path, monkeypatch):
    """hnsw_tpu_torch/tools/screen_split.py builds the kernel with
    -DSPLIT_NO_<part> to time the rest: each part it names must have one
    guard in each screen kernel's source around that part (the selection
    call, the epilogue, the product loop: screen_wgmma_kernel's first,
    then screen_ws_kernel's), and build() and the tool's own parallel
    builds must pass the macros to nvcc, so that the tool keeps measuring
    what it names."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(es.SOURCE), os.pardir, "tools",
                        "screen_split.py")
    spec = importlib.util.spec_from_file_location("screen_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(es.SOURCE) as f:
        src = f.read()
    want = {"SELECT": ("select_tile(", "ws_select("),
            "EPILOGUE": ("epilogue<SQEUCLIDEAN>",
                         "ws_epilogue<SQEUCLIDEAN, RAW>"),
            "PRODUCT": ("mma_tf32(acc, a_hi + off, b_lo + off, keep)",
                        "mma_bf16(acc, da + 2 * k, db + 2 * k")}
    assert {p for parts in tool.VARIANTS.values() for p in parts} == set(want)
    for name, insides in want.items():
        assert src.count(f"#ifndef SPLIT_NO_{name}\n") == 2
        b = 0
        for inside in insides:
            a = src.index(f"#ifndef SPLIT_NO_{name}\n", b)
            b = src.index(f"#endif  // SPLIT_NO_{name}\n", a)
            assert inside in src[a:b]
    assert src.index("screen_ws_kernel(const") < src.index(
        "mma_bf16(acc, da + 2 * k") < src.index("const void* ws_fn(")
    seen_tool = []

    def fake_tool_run(cmd, **kw):
        seen_tool.append(cmd)
        return types.SimpleNamespace(returncode=0, stderr="ptxas info")
    monkeypatch.setattr(tool.subprocess, "run", fake_tool_run)
    monkeypatch.setattr(es, "_nvcc", lambda: "nvcc")
    assert tool._build(es, str(tmp_path / "v"), ("SELECT", "PRODUCT")) == (
        "ptxas info")
    assert "-DSPLIT_NO_SELECT" in seen_tool[0]
    assert "-DSPLIT_NO_PRODUCT" in seen_tool[0]
    assert seen_tool[0][seen_tool[0].index("-o") + 1] == str(
        tmp_path / "v" / "libexact_screen.so")

    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return types.SimpleNamespace(returncode=0, stderr="")
    monkeypatch.setattr(es, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(es, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(es.subprocess, "run", fake_run)
    es.build(("SPLIT_NO_SELECT", "SPLIT_NO_EPILOGUE"))
    assert "-DSPLIT_NO_SELECT" in seen[0] and "-DSPLIT_NO_EPILOGUE" in seen[0]
    assert (tmp_path / "libexact_screen.so").exists()
