"""The generator repeats for a seed and gives continuous values; the rows
are one set whatever the seed, in the seed's order."""

import torch

from portbench import datagen

PARAMS = dict(data_seed=1, subspace=6, clusters=5, center_std=2.0,
              spread_log_std=0.3, noise_std=0.05, offset=0.7, scale=40.0)


def _sorted_rows(x):
    return x[torch.argsort(x[:, 0])]


def test_same_seed_same_rows_and_queries():
    seed = 2 ** 31 + 12345
    a = datagen.generate(PARAMS, 3000, 100, 20, seed, "cpu")
    b = datagen.generate(PARAMS, 3000, 100, 20, seed, "cpu")
    c = datagen.generate(PARAMS, 3000, 100, 20, seed + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].shape == (3000, 20) and a[1].shape == (100, 20)
    assert a[0].dtype == torch.float32
    # another seed: the same rows in another order, other queries
    assert not torch.equal(a[0], c[0])
    assert torch.equal(_sorted_rows(a[0]), _sorted_rows(c[0]))
    assert not torch.equal(a[1], c[1])
    other = datagen.generate(dict(PARAMS, data_seed=2), 3000, 100, 20, seed,
                             "cpu")
    assert not torch.equal(_sorted_rows(a[0]), _sorted_rows(other[0]))


def test_rows_are_continuous_and_low_dimensional():
    rows, queries = datagen.generate(PARAMS, 4000, 50, 32, 9, "cpu")
    assert torch.isfinite(rows).all() and torch.isfinite(queries).all()
    assert torch.unique(rows, dim=0).shape[0] == rows.shape[0]
    s = torch.linalg.svdvals(rows - rows.mean(0))
    # the mixture's subspace holds nearly all the variance
    assert (s[:6] ** 2).sum() / (s ** 2).sum() > 0.98
