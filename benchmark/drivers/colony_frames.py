"""Colony frames: a bonded colony at its full capacity (so no cell
divides) stepped in frames through `Simulation.run`, each ending in a
device synchronise.

Traffic keys: cells, steps_per_frame, warmup_frames, traced_frames,
checks, check_within_frames.

Checked frames: the reference (reference/<config reference>.py) steps the
frame from its start (frame 0, the first warm-up frame: the benchmark's
own inputs; later frames: the program's state at the frame's start) and
the program's state at its end is compared cell by cell; the bond table
must be the one the benchmark handed over, and no cell may have left the
contact layout (its overflow count) in any step of the run.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness.frames import FrameDriver, gap, no_span, worst
from benchmark.harness.spec import module


class Driver(FrameDriver):
    def setup(self) -> None:
        from sph_tpu_torch.engine.config import (
            reference_genome,
            reference_scene_params,
        )
        from sph_tpu_torch.engine.simulation import Simulation

        t = time.perf_counter()
        n = int(self.traffic["cells"])
        scene = module("scenes", self.cfg["scene"]).build(
            self.cfg, self.seed, n, self.device)
        self.inputs = scene
        self.units = n
        self.p = {**self.cfg["params"], "spawn_radius": scene["spawn_radius"]}
        self.g = self.cfg["genome_mode0"]
        self.ref = module("reference", self.cfg["reference"])
        self.bonds = len(scene["ia"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"scene: {n} cells, {self.bonds} bonds, spawn radius "
                 f"{scene['spawn_radius']!r} "
                 f"({time.perf_counter() - t:.3f} s)")

        prog = self.cfg["program"]
        params = reference_scene_params(
            capacity=n, max_bonds=scene["max_bonds"], **self.p,
            **{k: v for k, v in prog.items() if k != "scan_chunk"})
        genome = reference_genome()
        mode = genome.modes[0]
        for k, v in self.g.items():
            if getattr(mode, k) != v:
                raise SystemExit(f"the program's genome has {k} = "
                                 f"{getattr(mode, k)!r}, the configuration "
                                 f"{v!r}")
        self.sim = Simulation(genome, params, auto_grow=False,
                              scan_chunk=prog["scan_chunk"],
                              device=self.device)
        self.sim.state = self._state(params)

        t = time.perf_counter()
        self.snaps[-1] = {"start": self.sim.state}
        for w in range(int(self.traffic["warmup_frames"])):
            self.frame(no_span)
            if w == 0:
                self.snaps[-1]["end"] = self.sim.state
        self.log(f"warm-up: {self.traffic['warmup_frames']} frames "
                 f"({time.perf_counter() - t:.3f} s); bonds active "
                 f"{int(self.sim.state.bonds.active.sum())}, contact "
                 f"overflow {int(self.sim.state.overflow)}")
        # Frame 0 of the checks is the first warm-up frame.
        self.check_frames.discard(0)

    def _state(self, params):
        """The program's SimState of the benchmark's colony, assembled
        through the program's public types."""
        from sph_tpu_torch.core.types import BondTable, SimState

        s, dev = self.inputs, self.device
        n, nb, B = self.units, self.bonds, s["max_bonds"]

        def pad(a, fill, dt):
            a = a.to(dt)
            return torch.cat([a, torch.full((B - nb, *a.shape[1:]), fill,
                                            dtype=dt, device=dev)])

        def full(fill, dt, *shape):
            return torch.full((nb, *shape), fill, dtype=dt, device=dev)

        i32, f32, b8 = torch.int32, torch.float32, torch.bool
        ident = torch.zeros((nb, 4), device=dev)
        ident[:, 3] = 1.0
        bonds = BondTable(
            active=pad(full(True, b8), False, b8),
            uid_a=pad(s["ia"], -1, i32), uid_b=pad(s["ib"], -1, i32),
            slot_a=pad(s["ia"], -1, i32), slot_b=pad(s["ib"], -1, i32),
            zone_a=pad(s["zone_a"], 0, i32), zone_b=pad(s["zone_b"], 0, i32),
            child_to_child=pad(full(False, b8), False, b8),
            created_step=pad(full(-10, i32), -10, i32),
            rel_orientation=pad(ident, 0.0, f32),
            anchor_a=pad(s["anchor_a"], 0.0, f32),
            anchor_b=pad(s["anchor_b"], 0.0, f32),
            anchors_set=pad(full(True, b8), False, b8),
        )
        ints = dict(dtype=i32, device=dev)
        return SimState.zeros(n, params, seed=self.seed % 2 ** 31,
                              device=dev).replace_fields(
            **{k: s[k].clone()
               for k in ("pos", "radius", "mass", "inertia", "drag")},
            mode=torch.zeros(n, **ints), uid=torch.arange(n, **ints),
            parent_uid=torch.full((n,), -1, **ints),
            active_count=torch.tensor(n, **ints),
            next_uid=torch.tensor(n, **ints), bonds=bonds)

    def frame(self, span) -> int:
        with span("bench.frame"):
            with span("bench.steps"):
                self.sim.run(self.steps_per_frame)
        return self.steps_per_frame

    def before_frame(self, i: int) -> None:
        if i in self.check_frames:
            self.snaps[i] = {"start": self.sim.state}

    def after_frame(self, i: int) -> None:
        self.count_bad(self.sim.state.pos)
        if i in self.snaps:
            self.snaps[i]["end"] = self.sim.state

    def finish(self) -> dict:
        st = self.sim.state
        self.overflow = int(st.overflow)
        info = {"bonds_active": int(st.bonds.active.sum()),
                "contact_overflow": self.overflow}
        self.sim = None
        return info

    # -- correctness ---------------------------------------------------------

    def check(self, control: bool = False) -> dict:
        """The compared numbers, worst over the checked frames. control:
        the reference in bfloat16 stands in the program's place."""
        s, dev = self.inputs, self.device
        cells = {k: s[k] for k in ("radius", "mass", "inertia", "drag")}
        nb = self.bonds
        ident = torch.zeros((nb, 4), device=dev)
        ident[:, 3] = 1.0
        bonds = {"ia": s["ia"], "ib": s["ib"], "anchor_a": s["anchor_a"],
                 "anchor_b": s["anchor_b"], "rel_orientation": ident}
        r_max = float(s["radius"].max())
        dt = self.p["dt"]
        readings = []
        for i in sorted(self.snaps):
            snap = self.snaps[i]
            if "end" not in snap:
                continue
            if i == -1:
                n = self.units
                start = {"pos": s["pos"],
                         "vel": torch.zeros((n, 3), device=dev),
                         "ang": torch.zeros((n, 3), device=dev),
                         "rot": ident[:1].expand(n, 4).clone()}
            else:
                start = _fields(snap["start"])
            want = self.ref.run(start, cells, bonds, self.p, self.g,
                                self.steps_per_frame)
            if control:
                got = self.ref.run(start, cells, bonds, self.p, self.g,
                                   self.steps_per_frame,
                                   dtype=torch.bfloat16)
                bond_diff = 0
            else:
                got = _fields(snap["end"])
                active = snap["end"].bonds.active
                bond_diff = int(active[:nb].logical_not().sum()
                                + active[nb:].sum())
            r = {"pos_gap": gap(got["pos"], want["pos"], r_max),
                 "vel_gap": gap(got["vel"], want["vel"], r_max / dt),
                 "rot_gap": gap(got["rot"], want["rot"], 1.0),
                 "spin_gap": gap(got["ang"], want["ang"], 1.0 / dt),
                 "bonds_changed": float(bond_diff)}
            self.log(f"check frame {'warm-up 0' if i == -1 else i}: "
                     + ", ".join(f"{k} {v!r}" for k, v in r.items()))
            readings.append(r)
        # The reference keeps every cell in its contact search.
        return {**worst(readings),
                "contact_overflow": 0.0 if control else float(self.overflow)}


def _fields(st) -> dict:
    return {"pos": st.pos, "vel": st.vel, "ang": st.ang_vel, "rot": st.rot}
