"""The fused exact screen (K1) of hnsw_tpu_torch against hnsw_tpu's.

On the CPU the port's ``exact_topk_fused`` runs its plain torch screen;
the JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas.py does. The port's int64 keys differ from the TPU's
packed int32 keys on purpose, so the two are held equal after the f32
rerank: ids equal and distances within 1e-5 (f32 sums in another
order). With fast_math both round the Gram operands to bf16, but at other
places in the two frameworks, so the pools may be cut at different
places: id overlap >= 0.999, matched distances within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.ops.pallas_exact import exact_topk_fused as jax_fused  # noqa
from hnsw_tpu_torch.ops import exact_screen as es  # noqa: E402

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
