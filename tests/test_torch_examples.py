"""The reference's four examples on the port (``repro_torch.examples``),
each ``main`` run on the CPU: quickstart's LL and HT errors against the
dense oracle under the reference's 1e-4; serve_decode's engine statistics
equal to those of the reference's ``examples/serve_decode.py`` run in
this process; train_moe_e2e at a reduced width and step count (its loss
falls, its injected failure recovers); elastic_restart at a reduced step
count (it re-meshes from EP 4 to EP 2, restores and continues)."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.examples import (elastic_restart, quickstart,  # noqa: E402
                                  serve_decode, train_moe_e2e)

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.timeout(300)


def test_quickstart_within_the_reference_tolerance(capsys):
    res = quickstart.main(["--device", "cpu"])
    assert set(res["max_abs_err"]) == {"LL", "HT"}
    assert all(e < 1e-4 for e in res["max_abs_err"].values())
    assert res["oracle_max"] > 0.1                   # the oracle is not ~0
    assert "quickstart OK" in capsys.readouterr().out


def _reference_serve_stats(monkeypatch):
    """The reference's ``examples/serve_decode.py`` run as it is, its
    engine's ``run()`` result caught on the way out."""
    spec = importlib.util.spec_from_file_location(
        "reference_serve_decode", ROOT / "examples" / "serve_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    caught = {}

    class Engine(mod.ServingEngine):
        def run(self, *a, **kw):
            caught["stats"] = super().run(*a, **kw)
            return caught["stats"]
    monkeypatch.setattr(mod, "ServingEngine", Engine)
    mod.main()
    return caught["stats"]


def test_serve_decode_stats_equal_the_reference(monkeypatch, capsys):
    ref = _reference_serve_stats(monkeypatch)
    ref_out = capsys.readouterr().out
    got = serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got == ref
    assert got["sched_completed"] == 16
    # the same report, line for line
    assert out == ref_out


def test_train_moe_e2e_reduced(monkeypatch, capsys):
    monkeypatch.setattr(train_moe_e2e, "MODEL", dict(
        n_layers=2, d_model=128, n_experts=8, vocab=1024, d_expert=256))
    res = train_moe_e2e.main(["--device", "cpu", "--steps", "80",
                              "--batch", "8", "--seq", "64"])
    out = capsys.readouterr().out
    assert "simulated failure at step 40" in out
    assert "[e2e] OK" in out
    assert "restored" not in out.split("simulated failure")[0]
    # the failure at step 40 restores the checkpoint of step 25, and steps
    # 25-39 run again: 80 + 15 steps run
    assert res["steps_run"] == 95 == len(res["step_seconds"])
    assert res["losses"][-1] < res["losses"][0] - 0.3


def test_elastic_restart_restores_and_continues(monkeypatch, capsys):
    monkeypatch.setattr(elastic_restart, "STEPS", 40)
    res = elastic_restart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    plan = res["plan"]
    assert (plan.old_shape, plan.new_shape) == ((4,), (2,))
    assert (plan.ep_degree_old, plan.ep_degree_new) == (4, 2)
    assert plan.notes == ["experts/shard: 4 -> 8"]
    assert res["restored_step"] == 20
    # the reference's counts: STEPS // 2 steps at EP 4, then STEPS at EP 2
    assert len(res["hist1"]) == 20
    assert len(res["hist2"]) == 40
    assert res["hist2"][-1]["loss"] <= res["hist1"][-1]["loss"] + 0.2
    assert "[elastic] OK" in out
