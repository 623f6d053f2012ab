"""Fluid frames: a dam break stepped in frames through
`FluidSimulation.run` (each ends in a device synchronise), in episodes
that restart from the seeded column.

Traffic keys: particles, steps_per_frame, episode_frames, warmup_frames,
traced_frames, checks, check_within_frames (the episode's frames to
draw the checked frames from).

Every episode of `episode_frames` frames starts from a FluidSimulation
built anew from the benchmark's inputs, untimed, in before_frame. The
program's device counters (`dropped`, `clamped`, the rebin's demand peak)
are read once a frame after it, outside the timed frame.

Checked frames: frame 0 (the benchmark's own inputs) and one frame drawn
from the seed in each third of check_within_frames. The reference
(reference/<config reference>.py) steps each from the program's
particles at the frame's start, and the program's particles at its end
are matched to the reference's by nearest position (the rebin reorders
slots): `lost` is the reference's particles with no program particle
plus the run's `dropped`; `pos_gap` the Hausdorff distance ÷ h; `vel_gap`
max |Δv| of matched pairs ÷ c; `rho_gap` max |Δρ| of matched pairs ÷ ρ0
(the ρ of the frame's last step, which a rebin moves with its particle).

`bonds` hands the harness the interacting pairs: the unordered particle
pairs closer than h, averaged over the traced frames' start and end (the
per-pair work the sweeps' rooflines count).
"""

from __future__ import annotations

import time

import torch

from benchmark.harness.frames import FrameDriver, no_span, worst
from benchmark.harness.spec import module
from benchmark.reference.grid import (
    OFFSETS,
    _candidates,
    _cells,
    _key,
    _table,
    pairs_within,
)


def _flat(dstate) -> dict:
    """The program's particles, flat: positions, velocities and ρ of the
    occupied slots of a DenseFluidState."""
    occ = dstate.occ.reshape(-1) > 0.5

    def f(*planes):
        return torch.stack([p.reshape(-1)[occ] for p in planes], -1)

    return {"pos": f(dstate.px, dstate.py, dstate.pz),
            "vel": f(dstate.vx, dstate.vy, dstate.vz),
            "rho": dstate.rho.reshape(-1)[occ]}


def nearest(query, points, radius: float):
    """For each row of `query`, the index of the nearest row of `points`
    and its distance; distance inf (index 0) where none lies within
    `radius`. A cell list of edge `radius` over both sets."""
    both = torch.cat([points, query]).float()
    c, strides = _cells(both, both.min(0).values, radius)
    table = _table(_key(c[:len(points)], strides))
    qc = c[len(points):]
    best = torch.full((len(query),), float("inf"), device=query.device)
    arg = torch.zeros(len(query), dtype=torch.long, device=query.device)
    for off in OFFSETS:
        j, ok = _candidates(qc, strides, table, off)
        d = query[:, None, :].float() - points[j].float()
        dist = torch.sqrt((d * d).sum(-1))
        dist = torch.where(ok, dist, float("inf"))
        m, t = dist.min(1)
        better = m < best
        best = torch.where(better, m, best)
        arg = torch.where(better, j.gather(1, t[:, None])[:, 0], arg)
    best = torch.where(best < radius, best, float("inf"))
    return arg, best


def compare(got: dict, want: dict, ph: dict) -> dict:
    """The compared numbers of one frame (without the run's drops)."""
    h = ph["h"]
    idx, dist = nearest(want["pos"], got["pos"], h)
    _, back = nearest(got["pos"], want["pos"], h)
    unmatched = int(torch.isinf(dist).sum())
    lost = max(len(want["pos"]) - len(got["pos"]), 0) + unmatched
    hausdorff = max(float(dist.max()), float(back.max()))
    ok = torch.isfinite(dist)
    dv = got["vel"][idx] - want["vel"]
    dv = torch.sqrt((dv * dv).sum(-1))[ok]
    drho = (got["rho"][idx] - want["rho"]).abs()[ok]

    def top(x):
        if not bool(torch.isfinite(x).all()):
            return float("inf")
        return float(x.max()) if len(x) else 0.0

    return {"lost": float(lost), "pos_gap": hausdorff / h,
            "vel_gap": top(dv) / ph["sound_speed"],
            "rho_gap": top(drho) / ph["rest_density"]}


class Driver(FrameDriver):
    def __init__(self, cell, seed, device, log):
        super().__init__(cell, seed, device, log)
        import numpy as np

        # Frame 0 and one frame from each third of the first episode.
        frames = int(self.traffic["check_within_frames"])
        rng = np.random.default_rng([seed, 19])
        edges = [1 + (frames - 1) * k // 3 for k in range(4)]
        self.check_frames = {0, *(int(rng.integers(a, b))
                                  for a, b in zip(edges, edges[1:]))}

    def setup(self) -> None:
        from benchmark.run import PROFILER_WARMUP
        from sph_tpu_torch.ops import reset_rebin_peak
        from sph_tpu_torch.sph.model import SPHParams

        t = time.perf_counter()
        cfg, prog = self.cfg, self.cfg["program"]
        scene = module("scenes", self.cfg["scene"]).build(
            cfg, self.seed, self.device)
        self.pos0 = scene.pop("pos")
        self.units = len(self.pos0)
        if self.units != int(self.traffic["particles"]):
            raise SystemExit(f"the scene has {self.units} particles, the "
                             f"traffic {self.traffic['particles']}")
        self.ph = scene
        self.params = SPHParams(
            ndim=scene["ndim"], h=scene["h"],
            rest_density=scene["rest_density"],
            particle_mass=scene["particle_mass"],
            sound_speed=scene["sound_speed"], gamma=scene["gamma"],
            viscosity=scene["viscosity"], gravity=scene["gravity"],
            dt=scene["dt"], bounds_min=scene["bounds_min"],
            bounds_max=scene["bounds_max"],
            boundary_damping=scene["boundary_damping"],
            obstacles=scene["obstacles"],
            obstacle_stiffness=scene["obstacle_stiffness"],
            dense_k=prog["dense_k"], cell_factor=prog["cell_factor"],
            rebin_every=prog["rebin_every"], use_pallas=prog["use_pallas"])
        # The speed limit the layout sets (the program's rebin reach).
        cell = prog["cell_factor"] * scene["h"]
        self.ph["vmax"] = ((cell - scene["h"]) * 0.5
                           / (prog["rebin_every"] * scene["dt"]))
        self.ref = module("reference", cfg["reference"])
        self.episode = int(self.traffic["episode_frames"])
        # The harness traces the window's frames PROFILER_WARMUP onwards.
        self.count_at = {PROFILER_WARMUP,
                         PROFILER_WARMUP + int(self.traffic["traced_frames"])}
        self.pair_counts = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"scene: {self.units} particles, h {scene['h']!r}, dt "
                 f"{scene['dt']!r}, vmax {self.ph['vmax']!r} "
                 f"({time.perf_counter() - t:.3f} s)")

        self.dropped = self.clamped = self.peak = 0
        reset_rebin_peak()
        self.sim = None
        self._restart()
        t = time.perf_counter()
        for _ in range(int(self.traffic["warmup_frames"])):
            self.frame(no_span)
        self.after_frame(-1)
        self.log(f"warm-up: {self.traffic['warmup_frames']} frames "
                 f"({time.perf_counter() - t:.3f} s); dropped "
                 f"{self.dropped}, rebin peak {self.peak}")

    def _restart(self) -> None:
        """A FluidSimulation built anew from the benchmark's inputs."""
        from sph_tpu_torch.engine.fluid import FluidSimulation
        from sph_tpu_torch.sph.model import SPHState

        if self.sim is not None:
            self._read_counters(final=True)
        self.sim = None
        self.sim = FluidSimulation(
            SPHState.from_positions(self.pos0, self.params), self.params,
            substeps=self.steps_per_frame, device=self.device)

    def _counters(self):
        """(dropped, clamped, peak) of the running episode, one read."""
        c = self.sim.counters()
        return [int(v) for v in torch.stack(
            [c["dropped"], c["clamped"], c["rebin_peak"]]).tolist()]

    def _read_counters(self, final: bool = False) -> None:
        dropped, clamped, peak = self._counters()
        self.peak = max(self.peak, peak)
        if final:
            self.dropped += dropped
            self.clamped += clamped

    def frame(self, span) -> int:
        with span("bench.frame"):
            with span("bench.steps"):
                self.sim.run(self.steps_per_frame)
        return self.steps_per_frame

    def before_frame(self, i: int) -> None:
        if i % self.episode == 0:
            self._restart()
        if i in self.count_at:
            pos = _flat(self.sim.dstate)["pos"]
            self.pair_counts.append(len(pairs_within(pos, self.ph["h"])[0]))
            self.bonds = sum(self.pair_counts) // (2 * len(self.pair_counts))
        if i in self.check_frames:
            self.snaps[i] = {"start": _flat(self.sim.dstate)}

    def after_frame(self, i: int) -> None:
        d = self.sim.dstate
        self.count_bad(d.px, d.py, d.pz)
        self._read_counters()
        if i in self.snaps:
            self.snaps[i]["end"] = _flat(d)

    def finish(self) -> dict:
        self._read_counters(final=True)
        self.sim = None
        return {"dropped": self.dropped, "clamped": self.clamped,
                "rebin_peak": self.peak, "slots": self.params.dense_k,
                "pairs_within_h": getattr(self, "bonds", None)}

    # -- correctness ---------------------------------------------------------

    def check(self, control: bool = False) -> dict:
        """The compared numbers, worst over the checked frames. control:
        the reference in bfloat16 stands in the program's place."""
        readings = []
        for i in sorted(self.snaps):
            snap = self.snaps[i]
            if "end" not in snap:
                continue
            start = snap["start"]
            want = self.ref.run(start, self.ph, self.steps_per_frame)
            got = (self.ref.run(start, self.ph, self.steps_per_frame,
                                dtype=torch.bfloat16) if control
                   else snap["end"])
            r = compare(got, want, self.ph)
            self.log(f"check frame {i}: "
                     + ", ".join(f"{k} {v!r}" for k, v in r.items()))
            readings.append(r)
        out = worst(readings)
        if not readings:
            out = {"lost": float("inf")}
        if not control:
            out["lost"] = out.get("lost", 0.0) + float(self.dropped)
        return out
