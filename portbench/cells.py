"""Finds a cell and everything that belongs to it, by name.

``BENCHMARK.json`` names the cell, its configuration and its traffic mix.
Each piece sits in a file of its own, so a cell is added by adding files
and entries, never by editing one that is there:

* the configuration: the file its ``configs`` entry names;
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* the limits of the comparison that decides ``correct``:
  ``portbench/limits/<cell>.json``;
* each per-layer metric: a reader ``portbench/metrics/<metric>.py`` whose
  ``read(ctx)`` returns the number, or None where it finds nothing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the cell's entries of ``end_to_end`` and ``per_layer``
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, end_to_end: List[dict]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell (a per-layer metric: every cell that reports
    the end-to-end metric it ``moves``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric \
        or metric["moves"] in {m["name"] for m in end_to_end}


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; KeyError if it
    has none of that name."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, "portbench")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, [])]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(bench, "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in spec["per_layer"] if _reports(m, name, e2e)])


def reader(metric: str, root: str = ROOT) -> Callable[[Dict], object]:
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
