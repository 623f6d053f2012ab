"""The impact cell (`dam_break_impact_1m`) on the CPU: it finds its files
and reports what it must; its traffic pre-rolls a ~1,000-particle copy of
the configuration (the pillar moved in memory to touch the column, a
pre-roll of 10 steps), opens its window inside an episode, restores its
snapshot at the next and comes out correct with the push compared; a
copy whose pillar lies out of reach reads `push_missed` > 0, one whose
speed limit is lowered reads `clamped` > 0, and a program that miscounts
the push reads `push_gap` over its limit, and none is correct. A program
without the snapshot fails at once. The runs are traced, so that the
window runs at least 5 frames: the checked frames of the first whole
episode."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import spec
from benchmark.tests.conftest import cell_of

SEED = 2 ** 31 + 4000000123
CELL = "dam_break_impact_1m"


def test_cell_finds_its_files_and_reports_what_it_must():
    cell = cell_of(CELL)
    cfg, base = cell.config, cell_of("dam_break_1m").config
    for key in ("scene", "reference", "physics", "tank", "column",
                "obstacles", "jitter", "n_target", "precision"):
        assert cfg[key] == base[key], key
    assert cfg["reduced"] == [] and cfg["architecture"] is None
    assert set(cfg["limits"]) == {"lost", "clamped", "push_missed",
                                  "pos_gap", "vel_gap", "rho_gap",
                                  "push_gap"}
    for key in ("lost", "clamped", "push_missed"):
        assert cfg["limits"][key] == 0
    traffic = cell.traffic
    assert traffic["driver"] == "impact_frames"
    assert traffic["particles"] == 1_005_312
    assert traffic["preroll_steps"] % traffic["steps_per_frame"] == 0
    assert traffic["preroll_steps"] % cfg["program"]["rebin_every"] == 0
    assert traffic["check_within_frames"] == traffic["episode_frames"]
    assert (traffic["warmup_frames"] <= traffic["start_frame"]
            < traffic["episode_frames"])
    assert 0 < traffic["check_from_frame"] < traffic["episode_frames"]
    assert cell.entry["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"colony_throughput",
                                                     "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        *(f"{k}.fluid" for k in (
            "density_ms_per_step", "accel_ms_per_step", "rebin_ms_per_step",
            "density_roofline", "accel_roofline", "rebin_roofline",
            "idle_share")),
        "integrate_ms_per_step.fluid", "integrate_roofline.fluid"}
    spec.module("drivers", traffic["driver"]).Driver


def tiny(pillar=(0.65, 0.15), rebin_every=None):
    """The cell cut to ~1,000 particles, 2-step frames, a pre-roll of 10
    steps and 4-frame episodes whose window opens at their frame 3, with
    the pillar at `pillar`."""
    cell = cell_of(CELL)
    cfg = cell.config
    cfg["n_target"] = 1000
    cfg["obstacles"] = [["cylinder_z", list(pillar), 0.12]]
    if rebin_every is not None:
        cfg["program"] = {**cfg["program"], "rebin_every": rebin_every}
    cell.traffic.update(steps_per_frame=2, preroll_steps=10,
                        episode_frames=4, check_within_frames=4,
                        start_frame=3, check_from_frame=1,
                        warmup_frames=1, traced_frames=2, checks=3)
    build = spec.module("scenes", cfg["scene"]).build
    cell.traffic["particles"] = len(build(cfg, 1, "cpu")["pos"])
    return cell


def run(cell, tmp_path, **kw):
    from benchmark.run import run_cell

    torch.set_num_threads(2)
    return run_cell(cell, SEED, 0.1, True, dev="cpu", out=lambda msg: None,
                    trace_dir=tmp_path, **kw)


def test_impact_traffic_is_correct_with_the_push_compared(tmp_path):
    res = run(tiny(), tmp_path)
    assert res["correct"], res["checks"]
    c = res["checks"]
    assert c["push_missed"]["value"] == 0.0 and c["lost"]["value"] == 0.0
    assert c["clamped"]["value"] == 0.0 and c["push_gap"]["value"] == 0.0
    assert res["attempted"] >= 5


def test_a_miscounted_push_is_not_correct(tmp_path, monkeypatch):
    from sph_tpu_torch.engine.fluid import FluidSimulation

    counters = FluidSimulation.counters

    def doubled(self):
        c = counters(self)
        return {**c, "pushed": c["pushed"] * 2}

    monkeypatch.setattr(FluidSimulation, "counters", doubled)
    res = run(tiny(), tmp_path)
    assert res["checks"]["push_gap"]["value"] > 0.5
    assert not res["correct"], res["checks"]


def test_a_pillar_out_of_reach_is_not_correct(tmp_path):
    res = run(tiny(pillar=(1.8, 0.15)), tmp_path)
    assert res["checks"]["push_missed"]["value"] > 0
    assert not res["correct"], res["checks"]


def test_a_planted_clamp_is_not_correct(tmp_path):
    # A rebin every 40 steps leaves the layout a speed limit of ~0.7 m/s,
    # which the push of the pillar in the column exceeds.
    res = run(tiny(rebin_every=40), tmp_path)
    assert res["checks"]["clamped"]["value"] > 0
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(tmp_path):
    res = run(tiny(), tmp_path, control=True)
    assert not res["correct"], res["checks"]


def test_a_program_without_the_snapshot_fails_at_once(tmp_path,
                                                     monkeypatch):
    from sph_tpu_torch.engine.fluid import FluidSimulation

    monkeypatch.delattr(FluidSimulation, "snapshot")
    with pytest.raises(SystemExit, match="snapshot"):
        run(tiny(), tmp_path)
