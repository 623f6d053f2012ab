"""On the card: the impact cell at ~16,000 particles, its pillar moved to
touch the column, a pre-roll of 100 steps and a window that opens
halfway through an episode, through the program's kernels comes out
correct with no particle lost or clamped, the push compared in every
checked frame and F1's count of it within its limit of the reference's,
and its control (the reference in bfloat16 in the program's place) does
not. Skips without a card.

    python -m pytest --noconftest -q -m cuda benchmark/tests/test_bench_cuda_impact.py
"""

from __future__ import annotations

import time

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True])
def test_impact_cell_on_the_card(card, control):
    from benchmark.harness import spec
    from benchmark.run import run_cell
    from benchmark.tests.conftest import cell_of

    cell = cell_of("dam_break_impact_1m")
    cell.config["n_target"] = 16000
    cell.config["obstacles"] = [["cylinder_z", [0.65, 0.15], 0.12]]
    cell.traffic.update(preroll_steps=100, episode_frames=30,
                        check_within_frames=30, start_frame=15,
                        check_from_frame=5)
    build = spec.module("scenes", cell.config["scene"]).build
    cell.traffic["particles"] = len(build(cell.config, 1, "cpu")["pos"])
    res = run_cell(cell, 4000000101, 3.0, False, dev="cuda",
                   t0=time.perf_counter(), control=control,
                   out=lambda msg: None)
    assert res["correct"] is (not control), res["checks"]
    if not control:
        for key in ("lost", "clamped", "push_missed"):
            assert res["checks"][key]["value"] == 0.0, key
