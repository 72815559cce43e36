"""The comparison that decides ``correct`` fails the control and the
faults a graph-search cell can have; the program as configured passes.

The runs skip the look for a card and drive the rest of a run on the CPU
(the program's plain search), at sizes a test run holds. The exchange
between chips is not a fault these one-chip cells can have."""

import pytest

from portbench import cells, control, run

from .conftest import TINY_LIMITS, make_root


def _run(root, cell, seed, **kw):
    return run.run(cell, seed, 0.2, False, root=root, device="cpu",
                   require_card=False, **kw)


@pytest.fixture(scope="module")
def easy(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("easy"), "tiny.easy")


@pytest.mark.parametrize("seed", [2, 3])
def test_control_in_lower_precision_is_not_correct(tmp_path, seed):
    """The program's own lower precision (``fast_math``: bf16 operands in
    the search, an f32 rerank of the pool's head) goes another way than
    the configured float32 search, and ``walk_diff`` sees it."""
    root = make_root(tmp_path, "tiny.hard")
    sound = _run(root, "tiny.hard", seed)
    assert sound["correct"], sound["checks"]
    assert sound["checks"]["walk_diff"]["value"] == 0.0
    control = _run(root, "tiny.hard", seed,
                   prepare=lambda g: setattr(g, "fast_math", True))
    assert not control["correct"]
    assert control["checks"]["walk_diff"]["value"] > 0.003


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_faults_are_not_correct(easy, monkeypatch, fault):
    """Each fault of ``control.FAULTS`` planted under the timed path: a
    search that returns the state it was given, half of the batch left
    out, one answer altered."""
    import hnsw_tpu_torch.index.hnsw as hnsw
    assert _run(easy, "tiny.easy", 4)["correct"]
    real = hnsw.search_graph
    monkeypatch.setattr(hnsw, "search_graph", lambda g, q, **kw:
                        control.FAULTS[fault](real, g, q, kw))
    assert not _run(easy, "tiny.easy", 4)["correct"]


def test_a_build_without_reverse_edges_is_not_correct(easy):
    """A fault of the build, ``control.BUILD_FAULTS["no_reverse_edges"]``:
    the search follows the program's own graph, so ``walk_diff`` cannot
    see it, and ``recall_miss`` against the exact top 10 does."""
    conf = cells.load("tiny.easy", easy).config
    with control.BUILD_FAULTS["no_reverse_edges"](conf) as graph_kw:
        r = _run(easy, "tiny.easy", 4, graph_kw=graph_kw)
    assert not r["correct"]
    assert r["checks"]["walk_diff"]["value"] == 0.0
    assert r["checks"]["recall_miss"]["value"] \
        > TINY_LIMITS["recall_miss"]


@pytest.mark.parametrize("counts, fault", [
    ((3, 3, 0), False), ((3, 2, 0), True), ((3, 6, 0), True),
    ((3, 3, 1), True)])
def test_k5_fault(counts, fault):
    """On the card every call launches K5 once and no search runs the
    plain version; anything else is not the cell's path."""
    calls, launches, plain = counts
    w = run.Window([None] * calls, [], 0, 1.0, None, launches, plain)
    assert (w.k5_fault() is not None) == fault


@pytest.mark.cuda
def test_a_cell_on_the_card(card, tmp_path):
    """A tiny cell through the whole run on the card, traced: correct,
    K5 launched once a call, and every per-layer metric read."""
    root = make_root(tmp_path, "tiny.easy")
    r = run.run("tiny.easy", 7, 1.0, True, root=root)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"launches_per_batch", "syncs_per_batch",
                                 "k5_us_per_query", "k5_roofline",
                                 "device_idle_share", "build_vps.setup"}
    assert 0 < r["metrics"]["k5_roofline"]["value"] < 100
    assert r["device"]["busy_s"] > 0
