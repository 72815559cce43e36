"""search_graph in the store layouts: hnsw_tpu_torch against hnsw_tpu.

One natively built graph (tests/test_torch_layouts.built_graph) is laid
out by JAX's ``from_host`` in each serving layout and carried into the
port with ``device_graph_from_numpy``; both ``search_graph``s serve the
same queries, with the f32 rerank of the pool head on and off. This file
serves the fp16 / bf16 / int8 stores and the int8 capacity mode;
tests/test_torch_block_search.py the neighbor blocks and upper layouts. Id
overlap must be >= 0.99 and matched distances within 1e-5: hop distances
are f32 sums taken in another order, which can steer a near tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu.core import search as jsearch  # noqa: E402
from hnsw_tpu.core import state as jstate  # noqa: E402
from hnsw_tpu_torch.convert import device_graph_from_numpy  # noqa: E402
from hnsw_tpu_torch.core import search as tsearch  # noqa: E402
from tests.test_torch_layouts import (LAYOUTS, built_graph,  # noqa: E402
                                      jax_fields, overlap_and_err)


@pytest.fixture(scope="module")
def built():
    return built_graph()


def check_layout_search(built, layout, metric, rerank, merge):
    hosts, q = built
    jkw, _ = LAYOUTS[layout]
    jg = jstate.from_host(*hosts[metric], metric=metric, **jkw)
    tg = device_graph_from_numpy(jax_fields(jg), "cpu")
    kw = dict(k=10, ef=48, metric=metric, max_hops=64, expand=2,
              merge=merge, device_rerank=rerank,
              store_normalized=metric == "cosine")
    dj, ij = jsearch.search_graph(jg, jnp.asarray(q), **kw)
    stats = {}
    dt, it = tsearch.search_graph(tg, torch.from_numpy(q), stats=stats,
                                  **kw)
    ov, err = overlap_and_err(np.asarray(dj), np.asarray(ij), dt.numpy(),
                              it.numpy())
    assert ov >= 0.99 and err <= 1e-5, (ov, err)
    assert len(stats["hops"]) == tg.num_layers == 3


@pytest.mark.parametrize("layout,metric,rerank", [
    ("fp16-store", "cosine", True), ("bf16-store", "cosine", True),
    ("int8-store", "cosine", True), ("int8-store", "l2", False),
    ("quantized", "cosine", False)])
def test_search_graph_matches_jax_in_every_layout(built, layout, metric,
                                                  rerank):
    check_layout_search(built, layout, metric, rerank, "sort")
