"""tools/entry of the port against ``__graft_entry__.entry()``: the same
512 x 32 cosine graph (native build, m=8) and 64 queries from seed 1;
the port's ids overlap the JAX ids at >= 0.99 of positions, and where
the ids agree the distances agree within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__  # noqa: E402

from hnsw_tpu_torch.parallel import dryrun  # noqa: E402
from hnsw_tpu_torch.tools import entry as tentry  # noqa: E402


def test_entry_on_the_cpu_matches_jax():
    fn, args = __graft_entry__.entry()
    jd, ji = (np.asarray(x) for x in fn(*args))
    fn_t, args_t = tentry.entry(device="cpu")
    assert args_t[1].device.type == "cpu" and args_t[1].shape == (64, 32)
    td, ti = (x.numpy() for x in fn_t(*args_t))
    assert ti.shape == ji.shape == (64, 10)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ti, ji))
    assert hits / ji.size >= 0.99
    same = ti == ji
    assert np.abs(td[same] - jd[same]).max() <= 1e-5


def test_entry_reexports_dryrun_and_runs_from_the_command_line(capsys):
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip
    assert tentry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "entry ok: [(64, 10), (64, 10)]"


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tentry.entry()
