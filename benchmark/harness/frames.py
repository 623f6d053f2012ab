"""What every driver shares: the frames whose results are checked against
the plain reference (drawn from the seed), a count of frames that left a
non-finite position (accumulated on the device, read once), and the
comparison of a vector field with its reference."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class FrameDriver:
    """A traffic's driver. The harness calls setup(), then for each frame
    i of the window before_frame(i), frame(span) (timed) and after_frame(i),
    then finish() and check(). `units` is what one step advances: cells."""

    units: int = 0

    def __init__(self, cell, seed: int, device: str, log):
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.log = log
        self.steps_per_frame = int(self.traffic["steps_per_frame"])
        rng = np.random.default_rng([seed, 17])
        within = int(self.traffic["check_within_frames"])
        n = min(int(self.traffic["checks"]) - 1, within - 1)
        picked = rng.choice(np.arange(1, within), size=n, replace=False)
        # Frame 0 is always checked, from the benchmark's own inputs.
        self.check_frames = {0, *(int(f) for f in picked)}
        self.snaps = {}
        self._bad = torch.zeros((), dtype=torch.int64, device=self.device)

    def count_bad(self, *coords) -> None:
        """Add 1 on the device if a coordinate array holds a non-finite
        value (empty slots hold finite sentinels)."""
        ok = torch.stack([torch.isfinite(c).all() for c in coords]).all()
        self._bad += (~ok).to(torch.int64)

    def bad_frames(self) -> int:
        return int(self._bad)


def no_span(name):
    """A span that records nothing: frames outside a traced window."""
    return contextlib.nullcontext()


def gap(prog: torch.Tensor, ref: torch.Tensor, scale) -> float:
    """max |prog − ref| over rows (Euclidean over the last axis) ÷ scale;
    inf where prog is not finite."""
    if not bool(torch.isfinite(prog).all()):
        return float("inf")
    d = torch.sqrt(((prog - ref) ** 2).sum(-1)).max()
    return float(d / scale)


def worst(readings: list[dict]) -> dict:
    """Per name, the largest reading over the checked frames."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -1.0), v)
    return out
