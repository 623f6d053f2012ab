"""On the card: each listed cell at a test size through the program's kernels
comes out correct, and its control (the reference in bfloat16 in the
program's place) does not. Skips without a card.

    python -m pytest --noconftest -q -m cuda benchmark/tests/test_bench_cuda.py
"""

from __future__ import annotations

import time

import pytest

SMALL = {"colony_frames": ({}, {"cells": 4096})}


def _small(name: str):
    from benchmark.tests.conftest import cell_of

    cell = cell_of(name)
    cfg, traffic = SMALL[cell.traffic["driver"]]
    cell.config.update(cfg)
    cell.traffic.update(traffic, check_within_frames=40)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["colony_1m"])
@pytest.mark.parametrize("control", [False, True])
def test_cell_on_the_card(card, name, control):
    from benchmark.run import run_cell

    res = run_cell(_small(name), 4000000101, 2.0, False, dev="cuda",
                   t0=time.perf_counter(), control=control,
                   out=lambda msg: None)
    assert res["correct"] is (not control), res["checks"]
