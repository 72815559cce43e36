"""hnsw_tpu_torch.ops.hashing against hnsw_tpu.ops.hashing on the CPU.

The same seeded vectors and planes go through both ``hash_codes`` (JAX on
the CPU backend, torch on the CPU) and the numpy twins. Codes must be
equal, except for bits whose projection lies within 1e-6 of zero: f32
sums in another order may sign those differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.ops import hashing as jh  # noqa: E402
from hnsw_tpu_torch.ops import hashing as th  # noqa: E402


def _vectors(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _stable_mask(vectors, planes, tol=1e-6):
    """[N, T] True where every bit of the table has |projection| >= tol."""
    T, B, D = planes.shape
    proj = vectors.astype(np.float64) @ planes.reshape(T * B, D).T.astype(
        np.float64)
    return (np.abs(proj) >= tol).reshape(-1, T, B).all(axis=-1)


@pytest.mark.parametrize("tables,bits,dim", [(4, 8, 32), (8, 6, 16),
                                             (2, 30, 64), (1, 1, 8)])
def test_planes_and_codes_match_jax(tables, bits, dim):
    pj = jh.make_hyperplanes(tables, bits, dim, seed=42)
    pt = th.make_hyperplanes(tables, bits, dim, seed=42)
    np.testing.assert_array_equal(pt, pj)
    v = _vectors(7, 500, dim)
    cj = np.asarray(jh.hash_codes(jnp.asarray(v), jnp.asarray(pj)))
    ct = th.hash_codes(torch.from_numpy(v), torch.from_numpy(pt))
    assert ct.dtype == torch.int64 and tuple(ct.shape) == (500, tables)
    ok = _stable_mask(v, pt)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(ct.numpy()[ok], cj.astype(np.int64)[ok])


def test_numpy_twin_equals_the_device_codes():
    planes = th.make_hyperplanes(4, 8, 24, seed=3)
    v = _vectors(8, 300, 24)
    ok = _stable_mask(v, planes)
    got = th.np_hash_codes(v, planes)
    np.testing.assert_array_equal(got, jh.np_hash_codes(v, planes))
    dev = th.hash_codes(torch.from_numpy(v), torch.from_numpy(planes))
    np.testing.assert_array_equal(got[ok], dev.numpy()[ok])


def test_codes_are_the_packed_sign_bits():
    """Bit b of table t is 1 exactly where <v, planes[t, b]> > 0."""
    planes = th.make_hyperplanes(3, 5, 12, seed=1)
    v = _vectors(9, 64, 12)
    codes = th.hash_codes(torch.from_numpy(v),
                          torch.from_numpy(planes)).numpy()
    proj = np.einsum("nd,tbd->ntb", v.astype(np.float64),
                     planes.astype(np.float64))
    for b in range(5):
        np.testing.assert_array_equal((codes >> b) & 1, proj[:, :, b] > 0)


def test_too_many_bits_raises():
    planes = torch.zeros((1, 31, 4))
    with pytest.raises(ValueError, match="num_bits"):
        th.hash_codes(torch.zeros((2, 4)), planes)


def test_a_zero_projection_sets_no_bit_as_in_jax():
    """proj > 0 sets the bit: a zero vector (every projection exactly 0)
    hashes to code 0 in every table, in both packages and on the host."""
    planes = th.make_hyperplanes(3, 5, 8, seed=1)
    v = np.zeros((2, 8), np.float32)
    want = np.asarray(jh.hash_codes(jnp.asarray(v), jnp.asarray(planes)))
    got = th.hash_codes(torch.from_numpy(v), torch.from_numpy(planes)).numpy()
    assert (want == 0).all() and (got == 0).all()
    assert (th.np_hash_codes(v, planes) == 0).all()
