"""Rows and queries at a published shape, made from the seed on the device.

No dataset can be fetched, so each configuration's rows come from this
generator, frozen here with its parameters in the configuration's file.
Real descriptors and embeddings have an intrinsic dimension far below
their width, and graph search depends on it (Aumueller & Ceccarello, "The
role of local intrinsic dimensionality in benchmarking nearest neighbor
search", SISAP 2019), so rows are not iid Gaussian: each is a point of a
Gaussian mixture in a random ``subspace``-dimensional subspace, plus
isotropic noise in every coordinate and a fixed positive ``offset``
vector, times ``scale``. Values are continuous, so exact distance ties
stay rare.

A dataset is one fixed set of rows, as an ANN-Benchmarks file is: the
mixture and its rows come from the configuration's ``data_seed``, so every
run searches the same geometry and does the same amount of work. The
run's seed orders the rows (the order the index inserts them in, which
shapes its graph) and draws the queries from the same mixture, apart from
the base rows as ANN-Benchmarks' test sets are.

Everything is drawn by ``torch.Generator``s on ``device`` in a few large
calls; the same seeds, shapes and device give the same arrays.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: rows drawn a call: bounds the temporary memory of a draw
_CHUNK = 1 << 18


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def generate(params: dict, n_rows: int, n_queries: int, dim: int,
             seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [n_rows, dim], queries [n_queries, dim]) float32 on
    ``device``. ``params``: ``data_seed`` (the mixture and its rows),
    ``subspace`` (r), ``clusters``, ``center_std`` (the centres' spread in
    the subspace), ``spread_log_std`` (each cluster's scale is exp of a
    normal draw of this deviation), ``noise_std`` (isotropic, every
    coordinate), ``offset`` (each coordinate of the offset vector is
    uniform in [0, 2 * offset]) and ``scale``. ``seed`` orders the rows
    and draws the queries."""
    device = torch.device(device)
    g = _generator(params["data_seed"], device)
    r, n_c = int(params["subspace"]), int(params["clusters"])
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    basis = torch.linalg.qr(torch.randn(dim, r, **f32))[0]          # [D, r]
    centers = torch.randn(n_c, r, **f32) * float(params["center_std"])
    spread = torch.exp(torch.randn(n_c, **f32)
                       * float(params["spread_log_std"]))
    offset = torch.rand(dim, **f32) * (2.0 * float(params["offset"]))
    noise, scale = float(params["noise_std"]), float(params["scale"])

    def draw(n: int, g: torch.Generator) -> torch.Tensor:
        out = torch.empty(n, dim, dtype=torch.float32, device=device)
        f = dict(f32, generator=g)
        for c0 in range(0, n, _CHUNK):
            m = min(_CHUNK, n - c0)
            z = torch.randint(n_c, (m,), generator=g, device=device)
            lat = centers[z] + torch.randn(m, r, **f) * spread[z, None]
            x = lat @ basis.T + torch.randn(m, dim, **f) * noise + offset
            out[c0:c0 + m] = x * scale
        return out

    rows = draw(int(n_rows), g)
    run = _generator(seed, device)
    rows = rows[torch.randperm(int(n_rows), generator=run, device=device)]
    return rows, draw(int(n_queries), run)
