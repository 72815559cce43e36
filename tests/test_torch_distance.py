"""hnsw_tpu_torch.ops.distance against hnsw_tpu.ops.distance on the CPU.

Same numpy inputs (seeded) into both packages. Tolerance atol 1e-5: both
compute f32 matmuls and epilogues, with sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.ops import distance as jd  # noqa: E402
from hnsw_tpu_torch.ops import distance as td  # noqa: E402

METRICS = ["cosine", "l2", "sqeuclidean", "dot"]


def _data(seed, *shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_dist_matches_jax(metric):
    q, v = _data(1, 40, 48), _data(2, 300, 48)
    want = np.asarray(jd.pairwise_dist(jnp.asarray(q), jnp.asarray(v),
                                       metric=metric))
    got = td.pairwise_dist(torch.from_numpy(q), torch.from_numpy(v),
                           metric=metric).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_gathered_dist_matches_jax(metric):
    q, c = _data(3, 16, 32), _data(4, 16, 24, 32)
    q_sq, c_sq = np.sum(q * q, -1), np.sum(c * c, -1)
    want = np.asarray(jd.gathered_dist(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c_sq),
        jnp.asarray(q_sq), metric=metric,
        precision=jax.lax.Precision.HIGHEST))
    got = td.gathered_dist(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(c_sq), torch.from_numpy(q_sq),
                           metric=metric, precision=td.HIGHEST).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_default_precision_rounds_operands_to_bf16(metric):
    """DEFAULT = bf16 x bf16 with f32 output: the same as HIGHEST on
    operands already rounded to bf16, and unlike HIGHEST on raw ones."""
    q, v = _data(5, 8, 64), _data(6, 50, 64)
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    vsq = td.sq_norms(tv)
    qsq = td.sq_norms(tq)
    fast = td.pairwise_dist(tq, tv, v_sq=vsq, q_sq=qsq, metric=metric,
                            precision=td.DEFAULT)
    rounded = td.pairwise_dist(td.bf16_round(tq), td.bf16_round(tv),
                               v_sq=vsq, q_sq=qsq, metric=metric)
    exact = td.pairwise_dist(tq, tv, metric=metric)
    np.testing.assert_allclose(fast.numpy(), rounded.numpy(), atol=1e-6)
    assert not torch.equal(fast, exact)


def test_numpy_twins_and_sq_norms_match_jax():
    q, v = _data(7, 10, 16), _data(8, 20, 16)
    for metric in METRICS:
        np.testing.assert_allclose(td.np_pairwise_dist(q, v, metric),
                                   jd.np_pairwise_dist(q, v, metric),
                                   atol=1e-6)
        assert td.point_dist(q[0], v[0], metric) == pytest.approx(
            jd.point_dist(q[0], v[0], metric), abs=1e-6)
    np.testing.assert_allclose(td.sq_norms(torch.from_numpy(v)).numpy(),
                               np.asarray(jd.sq_norms(jnp.asarray(v))),
                               atol=1e-6)
    assert td.INF_DIST == jd.INF_DIST and td._EPS == jd._EPS


def test_registry_custom_metric():
    name = "torch_test_l1"
    td.register_distance(
        name, lambda a, b: float(np.abs(a - b).sum()),
        pairwise_fn=lambda Q, V: torch.cdist(Q, V, p=1))
    q, v = _data(9, 4, 8), _data(10, 12, 8)
    want = np.abs(q[:, None, :] - v[None, :, :]).sum(-1)
    got = td.pairwise_dist(torch.from_numpy(q), torch.from_numpy(v),
                           metric=name).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert td.resolve_metric(name) == name
    with pytest.raises(ValueError):
        td.register_distance("cosine", lambda a, b: 0.0)
