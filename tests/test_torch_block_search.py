"""search_graph with neighbor blocks and split / compact upper layers:
hnsw_tpu_torch against hnsw_tpu, as in tests/test_torch_layout_search.py
(id overlap >= 0.99, matched distances within 1e-5)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.test_torch_layout_search import check_layout_search  # noqa: E402
from tests.test_torch_layouts import built_graph  # noqa: E402


@pytest.fixture(scope="module")
def built():
    return built_graph()


@pytest.mark.parametrize("layout,metric,rerank,merge", [
    ("blocks-int8", "cosine", True, "bitonic"),
    ("blocks-int8", "l2", True, "sort"),
    ("blocks-fp16", "l2", True, "sort"),
    ("blocks-auto-narrow", "cosine", True, "sort"),
    ("compact", "cosine", True, "sort"),
    ("split", "l2", False, "sort")])
def test_block_and_upper_layouts_match_jax(built, layout, metric, rerank,
                                           merge):
    check_layout_search(built, layout, metric, rerank, merge)
