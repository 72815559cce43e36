"""The port's examples (hnsw_tpu_torch/examples/) run on the CPU at their
small size, and every check each one prints holds (a failed check
raises). The counts are the checks each example makes."""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

CHECKS = {"quickstart": 5, "hybrid_and_facets": 5, "disk_and_scale": 4,
          "serving_ops": 3, "multichip": 3, "large_scale": 3}


@pytest.fixture(autouse=True)
def _quiet_builds(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BUILD_PROGRESS", "0")


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_example_runs_on_the_cpu_and_its_checks_hold(name, capsys):
    mod = importlib.import_module(f"hnsw_tpu_torch.examples.{name}")
    mod.main(device="cpu", small=True)
    out = capsys.readouterr().out.splitlines()
    oks = [ln for ln in out if ln.startswith("ok: ")]
    assert len(oks) == CHECKS[name], out


def test_examples_need_the_card_by_default(monkeypatch):
    from hnsw_tpu_torch.examples import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        quickstart.main()
