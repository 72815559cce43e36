"""Cells by name: a cell is added by adding files and entries only."""

import hashlib
import json
import os

import pytest

from portbench import cells

from .conftest import make_root


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_needs_no_edit(tmp_path):
    before = _digests(cells.ROOT)
    root = make_root(tmp_path, "tiny.easy")
    copied = _digests(root)
    # every file the benchmark has is in the copy, unedited
    for rel, digest in before.items():
        if rel.split(os.sep)[1] in ("configs", "traffic", "limits",
                                    "metrics"):
            assert copied[rel] == digest
    cell = cells.load("tiny.easy", root)
    assert cell.config["rows"] == 2000 and cell.traffic["ef"] == 32
    assert cell.limits["walk_diff"] == 0.003
    assert {m["name"] for m in cell.end_to_end} >= {"qps", "setup_s"}
    assert "k5_roofline" in {m["name"] for m in cell.per_layer}
    assert callable(cells.reader("k5_roofline", root))
    with pytest.raises(KeyError):
        cells.load("no.such.cell", root)


def test_every_cell_of_the_benchmark_loads():
    spec = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"invalid_answers", "dist_err",
                                    "walk_diff", "recall_miss",
                                    "graph_faults"}
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_per_layer_without_workloads_follows_what_it_moves():
    e2e = [{"name": "qps"}]
    assert cells._reports({"name": "x", "moves": "qps"}, "c", e2e)
    assert not cells._reports({"name": "x", "moves": "ttft"}, "c", e2e)
    assert not cells._reports({"name": "x", "moves": "qps",
                               "workloads": ["d"]}, "c", e2e)
