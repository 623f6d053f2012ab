"""The fluid cell (`dam_break_1m`) on the CPU: its driver drives the
program's plain route on a tiny seeded column and comes out correct, a
traced run reads, and the control (the reference in bfloat16 in the
program's place) and each planted fault — a dropped particle, a state
left unchanged, a particle moved by 0.1 h — come out not correct. The
cell's configuration keeps its published scene and the layout it states.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import spec
from benchmark.tests.conftest import cell_of

SEED = 4000000123


def tiny():
    """dam_break_1m cut to ~1,000 particles and 2-step frames."""
    cell = cell_of("dam_break_1m")
    cell.config["n_target"] = 1000
    cell.traffic.update(steps_per_frame=2, episode_frames=4,
                        check_within_frames=4, warmup_frames=1,
                        traced_frames=2)
    build = spec.module("scenes", cell.config["scene"]).build
    cell.traffic["particles"] = len(build(cell.config, 1, "cpu")["pos"])
    return cell


def run_tiny(traced=False, control=False, trace_dir=None):
    from benchmark.run import run_cell

    torch.set_num_threads(2)
    return run_cell(tiny(), SEED, 0.1, traced, dev="cpu", control=control,
                    out=lambda msg: None, trace_dir=trace_dir)


def test_configuration_is_config3_at_its_layout():
    cell = cell_of("dam_break_1m")
    cfg, traffic = cell.config, cell.traffic
    assert cfg["n_target"] == 1_000_000 and cfg["precision"] == "float32"
    assert cfg["reduced"] == [] and cfg["architecture"] is None
    assert cfg["obstacles"] == [["cylinder_z", [1.2, 0.15], 0.12]]
    assert cfg["program"]["dense_k"] == 16
    pos = spec.module("scenes", cfg["scene"]).build(cfg, SEED, "cpu")["pos"]
    assert len(pos) == traffic["particles"] == 1_005_312
    assert cell.entry["chips"] == 1
    names = {m["name"] for m in cell.per_layer}
    assert names == {f"{k}.fluid" for k in (
        "density_ms_per_step", "accel_ms_per_step", "rebin_ms_per_step",
        "density_roofline", "accel_roofline", "rebin_roofline",
        "idle_share")}


def test_scene_is_seeded_and_jittered_within_its_bound():
    cell = tiny()
    build = spec.module("scenes", cell.config["scene"]).build
    a, b = build(cell.config, 7, "cpu"), build(cell.config, 7, "cpu")
    c = build(cell.config, 2 ** 31 + 11, "cpu")
    assert torch.equal(a["pos"], b["pos"])
    assert not torch.equal(a["pos"], c["pos"])
    flat = build({**cell.config, "jitter": 0.0}, 7, "cpu")["pos"]
    jit = (a["pos"] - flat).abs().max() / a["dx"]
    assert 0.015 < float(jit) <= 0.0201


def test_traffic_drives_the_program_and_is_correct():
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"lost", "pos_gap", "vel_gap", "rho_gap"}
    assert res["checks"]["lost"]["value"] == 0.0
    assert {"colony_throughput", "setup_s"} <= set(res["metrics"])
    json.dumps(res, allow_nan=False)


def test_traced_run_reports_what_the_cpu_can(tmp_path):
    res = run_tiny(traced=True, trace_dir=tmp_path)
    assert (tmp_path / "trace.json").exists() and res["correct"]
    # No device on the CPU: the idle reader reads, the device-time and
    # roofline readers find no device work and stay silent.
    assert "idle_share.fluid" in res["metrics"]
    for m in ("density_ms_per_step.fluid", "density_roofline.fluid"):
        assert m not in res["metrics"]


def test_control_is_not_correct():
    res = run_tiny(control=True)
    assert not res["correct"], res["checks"]


def _fault(kind):
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.sph.dense import SENTINEL

    real = FluidSimulation.run

    def run(self, n):
        if kind == "unchanged":
            return 1.0
        out = real(self, n)
        d = self.dstate
        live = torch.nonzero(d.occ.reshape(-1) > 0.5)[0, 0]
        if kind == "dropped":
            fields = {f: getattr(d, f).clone() for f in ("occ", "px")}
            fields["occ"].view(-1)[live] = 0.0
            fields["px"].view(-1)[live] = SENTINEL
        else:
            fields = {"px": d.px.clone()}
            fields["px"].view(-1)[live] += 0.1 * self.params.h
        self.dstate = d.replace_fields(**fields)
        return out

    return FluidSimulation, run


@pytest.mark.parametrize("kind", ["dropped", "unchanged", "moved"])
def test_faults_are_not_correct(kind, monkeypatch):
    cls, run = _fault(kind)
    monkeypatch.setattr(cls, "run", run)
    res = run_tiny()
    assert not res["correct"], (kind, res["checks"])
