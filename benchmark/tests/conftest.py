"""Shared fixtures of the benchmark's CPU tests: cells shrunk to a size the
CPU steps in seconds, run through the harness with the chip check
skipped (the program's plain route on CPU tensors)."""

from __future__ import annotations

import torch

from benchmark.harness import spec

TINY = {
    "colony_frames": dict(config={},
                          traffic={"cells": 200, "warmup_frames": 1,
                                   "traced_frames": 2, "checks": 3,
                                   "check_within_frames": 3}),
}


def cell_of(name: str):
    """A cell of BENCHMARK.json."""
    return spec.find_cell(spec.load_benchmark(), name)


def tiny_cell(name: str):
    cell = cell_of(name)
    shrink = TINY[cell.traffic["driver"]]
    cell.config.update(shrink["config"])
    cell.traffic.update(shrink["traffic"])
    return cell


def run_tiny(name: str, seed: int = 20261017, seconds: float = 0.5,
             traced: bool = False, control: bool = False,
             trace_dir=None) -> dict:
    from benchmark.run import run_cell

    torch.set_num_threads(2)
    return run_cell(tiny_cell(name), seed, seconds, traced, dev="cpu",
                    control=control, out=lambda msg: None,
                    trace_dir=trace_dir)
