"""The port's dryrun_multichip on eight CPU shards, held to the JAX
package's recorded 8-device run (MULTICHIP_r05.json, its ``tail`` line):
every printed recall within 0.02 of that run's value for the same path,
and the exact paths (row-sharded exact, block-sharded IVF) equal to the
oracle. Only recall values are read from that file."""

import json
import os
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hnsw_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402

_RECORD = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "MULTICHIP_r05.json")
_PATHS = ("partitioned recall", "data-parallel recall",
          "int8 capacity\\+rerank recall", "fp16 graph capacity mode recall",
          "row-sharded SINGLE graph \\(.*?\\) recall",
          "MultiHostIndex over TCP recall")


def _recalls(line):
    out = []
    for p in _PATHS:
        m = re.search(p + r" ([0-9.]+)", line)
        assert m, (p, line)
        out.append(float(m.group(1)))
    return out


def test_dryrun_multichip_cpu_matches_the_jax_record(capsys):
    with open(_RECORD) as f:
        record = json.load(f)["tail"]
    got = dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(8): 4096 rows x 64d on 8 ")
    for name in ("row-sharded exact == oracle", "block-sharded IVF == oracle",
                 "all 8 paths executed and recall-checked OK"):
        assert name in line, name
    for mine, theirs in zip(_recalls(line), _recalls(record)):
        assert abs(mine - theirs) <= 0.02, (mine, theirs, line)
    assert got["multihost"] == 1.0 and min(got.values()) >= 0.9
