"""Each cell drives the program's CPU plain route on a tiny seeded scene
and comes out correct; the result has the contract's keys; the control
(the reference in bfloat16 in the program's place) and each fault a run
can have (a step that returns its state unchanged, half of the cells left
unstepped, one answer altered where it is produced) come out not
correct."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests.conftest import run_tiny

CELLS = ("colony_1m",)


@pytest.mark.parametrize("name", CELLS)
def test_traffic_drives_the_program_and_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert "setup_s" in res["metrics"]
    json.dumps(res, allow_nan=False)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name, tmp_path):
    res = run_tiny(name, traced=True, trace_dir=tmp_path)
    assert (tmp_path / "trace.json").exists()
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device on the CPU: the host and idle readers read, the roofline
    # reader finds no device work and stays silent.
    assert "host_ms_per_step.colony" in res["metrics"]
    assert "step_roofline.colony" not in res["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run_tiny(name, control=True)
    assert not res["correct"], res["checks"]


def _colony_fault(kind):
    from sph_tpu_torch.engine.simulation import Simulation

    real = Simulation.run

    def run(self, n):
        before = self.state
        if kind == "unchanged":
            return 1.0
        out = real(self, n)
        s = self.state
        if kind == "half":
            h = s.pos.shape[0] // 2
            self.state = s.replace_fields(**{
                f: torch.cat([getattr(before, f)[:h], getattr(s, f)[h:]])
                for f in ("pos", "vel", "ang_vel", "rot")})
        elif kind == "altered":
            pos = s.pos.clone()
            pos[0, 0] += 0.1
            self.state = s.replace_fields(pos=pos)
        return out

    return Simulation, run


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(name, kind, monkeypatch):
    cls, run = _colony_fault(kind)
    monkeypatch.setattr(cls, "run", run)
    res = run_tiny(name)
    assert not res["correct"], (kind, res["checks"])
