"""Fixtures of the benchmark's own tests: a throwaway root that holds a
copy of the benchmark's data and a tiny cell of its own."""

import json
import os
import shutil

import pytest
import torch

from portbench import cells

#: tiny cells run on the CPU: an easy one, and a hard one (a subspace of
#: half the width, ef 10) on which a lower-precision search goes another
#: way often enough to be seen
TINY = {
    "tiny.easy": dict(rows=2000, dim=32, queries=300, subspace=8, batch=128,
                      ef=32),
    "tiny.hard": dict(rows=4000, dim=64, queries=600, subspace=32,
                      batch=256, ef=10),
}
TINY_LIMITS = {"invalid_answers": 0, "dist_err": 1e-5, "walk_diff": 0.003,
               "recall_miss": 0.05, "graph_faults": 0}


def make_root(tmp, cell: str) -> str:
    """A copy of the benchmark's data under ``tmp`` with ``cell`` (one of
    ``TINY``) added by new files and entries only."""
    root = str(tmp)
    bench = os.path.join(root, "portbench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(cells.ROOT, "portbench", sub),
                        os.path.join(bench, sub))
    spec = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
    t = TINY[cell]
    conf = json.load(open(os.path.join(bench, "configs",
                                       "sift1m-l2-hnsw.json")))
    conf.update(name=cell, rows=t["rows"], dim=t["dim"],
                queries=t["queries"])
    conf["generator"] = dict(conf["generator"], subspace=t["subspace"])
    with open(os.path.join(bench, "configs", cell + ".json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(bench, "traffic", cell + ".json"), "w") as f:
        json.dump({"batch": t["batch"], "batches": 2, "k": 10,
                   "ef": t["ef"], "why": "a test"}, f)
    with open(os.path.join(bench, "limits", cell + ".json"), "w") as f:
        json.dump(TINY_LIMITS, f)
    spec["configs"].append({"name": cell, "source": "a test",
                            "file": f"portbench/configs/{cell}.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": cell,
                              "traffic": cell, "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        m.setdefault("workloads", []).append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
