"""Host-facing colony Simulation API — the counterpart of
sph_tpu.engine.simulation.Simulation (single device): init (Start,
cs:211-242), stepping, capacity growth (ResizeParticleBuffers,
cs:1162-1222), genome hot-reload (OnGenomeChanged, cs:357-367), interactive
drag (cs:975-1034), ids, bond visuals, metrics and checkpoints, on one
device or with the contact sweep sharded over a mesh of ranks. Steps run
in chunks of `scan_chunk`, which carry the adhesion BondPlan across calls.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.init import init_particles
from sph_tpu_torch.core.types import Genome, SimParams, SimState, formatted_id
from sph_tpu_torch.engine.step import run_steps, step, use_bond_plan
from sph_tpu_torch.physics.adhesion import build_bond_plan

# SimState fields that a resize carries over whole: the tables whose
# capacities do not change, the counters and the PRNG key. Every other
# field is a per-slot array.
_CARRIED = ("bonds", "pending", "drag_input", "active_count", "next_uid",
            "step_count", "overflow", "rng")


class Simulation:
    """A running colony simulation.

    >>> sim = Simulation(genome, SimParams(capacity=64))  # on the card
    >>> sim.run(600)
    >>> sim.metrics()
    """

    def __init__(self, genome: Genome, params: SimParams, seed: int = 0,
                 rng_mode: str = "jax", auto_grow: bool = False,
                 donate: bool = True, scan_chunk: int = 64, device="cuda",
                 mesh=None):
        """A fresh population from init_particles; to start from another
        state (a bonded colony, a state carried across from the JAX
        package), assign `sim.state` a SimState on `sim.device`.

        scan_chunk: `step` runs full chunks of this many steps through
        engine.step.run_steps, which carries the adhesion BondPlan where
        use_bond_plan says so (the JAX package scans such a chunk in one
        dispatch). donate: JAX's buffer donation, taken for the signature's
        sake; it has no effect here.

        mesh: a parallel.dist.Mesh (1D ring or 2D): every rank of it runs
        the simulation alike on the mesh's device, with the contact sweep
        decomposed over the ranks (dense neighbour mode only); division,
        bonds and integration stay replicated, and every rank holds
        bitwise the single-device state after every step."""
        self._setup(genome.validate_for_simulation(), params, seed, rng_mode,
                    auto_grow, device, mesh=mesh, donate=donate,
                    scan_chunk=scan_chunk)

    def _setup(self, genome: Genome, params: SimParams, seed: int,
               rng_mode: str, auto_grow: bool, device,
               state: SimState | None = None, mesh=None,
               donate: bool = True, scan_chunk: int = 64) -> None:
        """Every attribute of a sim, for __init__ and load: a fresh
        population unless `state` is given."""
        self.genome = genome
        self.params = params
        self.seed = seed
        self.rng_mode = rng_mode
        self.auto_grow = auto_grow
        self.donate = donate
        self.scan_chunk = max(1, scan_chunk)
        self._bond_plan = None
        self._bond_plan_cap = None
        self.mesh = mesh
        self.contact_fn = self._make_contact_fn(mesh)
        self.device = torch.device(device if mesh is None else mesh.device)
        self.genome_dev = genome.to_device(self.device)
        self.state: SimState = (self._fresh(params.capacity) if state is None
                                else state)
        self._steps_per_sec = float("nan")
        self.last_selected = -1   # lastSelectedParticleID (cs:125)

    def _fresh(self, capacity: int) -> SimState:
        """A fresh population of `capacity` slots under this sim's genome,
        seed and rng mode."""
        return init_particles(
            self.params, self.genome_dev, n_modes=len(self.genome.modes),
            initial_mode=self.genome.initial_mode_index, capacity=capacity,
            seed=self.seed, rng_mode=self.rng_mode, device=self.device)

    def _make_contact_fn(self, mesh):
        """The contact sweep sharded over a 1D z-slab ring or a 2D
        (z-slab × y-block) mesh (parallel/dist.py); None on one device."""
        if mesh is None:
            return None
        if self.params.neighbor_mode != "dense":
            raise ValueError("mesh-sharded contact requires neighbor_mode="
                             f"'dense' (got {self.params.neighbor_mode!r})")
        from sph_tpu_torch.parallel.dist import (
            make_sharded_contact_forces,
            make_sharded_contact_forces_2d,
        )

        if mesh.ndim == 2:
            return make_sharded_contact_forces_2d(self.params, mesh)
        return make_sharded_contact_forces(self.params, mesh)

    # -- stepping ------------------------------------------------------------

    def _plan_for_state(self):
        """The adhesion BondPlan carried across chunks, or None where
        use_bond_plan says no. A stale plan is valid (the hybrid finds the
        drifted bonds every step, and run_steps rebuilds it), so it is
        rebuilt here only when its key — (capacity, bond capacity) —
        changes, as after a resize."""
        if not use_bond_plan(self.params, self.state):
            return None
        cap = (self.state.capacity, self.state.bonds.capacity)
        if self._bond_plan is None or self._bond_plan_cap != cap:
            self._bond_plan = build_bond_plan(self.state.bonds,
                                              self.state.capacity)
            self._bond_plan_cap = cap
        return self._bond_plan

    def step(self, n: int = 1, dt=None) -> None:
        """Advance n physics steps. dt: a scalar for all n steps or a
        length-n sequence (variable-dt compat, cs:246), stepped one at a
        time with no plan; None = params.dt.

        Otherwise full chunks of `scan_chunk` steps go through run_steps
        with the carried plan, and what is left takes single steps with no
        plan. Under auto_grow the grow check runs before each chunk or
        single step, and a chunk is taken only where the headroom covers
        its splits (otherwise single steps), so the population cannot
        outgrow the capacity inside one: it grows at the JAX package's
        steps."""
        if dt is not None:
            dts = np.broadcast_to(np.asarray(dt, np.float32), (n,))
            for d in dts:
                if self.auto_grow:
                    self._maybe_grow()
                self.state = step(self.state, self.params, self.genome_dev,
                                  dt=float(d), contact_fn=self.contact_fn)
            return
        remaining = n
        while remaining > 0:
            safe = remaining
            if self.auto_grow:
                self._maybe_grow()
                headroom = self.state.capacity - int(self.state.active_count)
                safe = max(1, headroom
                           // max(1, self.params.max_splits_per_step))
            c = (self.scan_chunk if remaining >= self.scan_chunk
                 and safe >= self.scan_chunk else 1)
            if c == 1:
                self.state = step(self.state, self.params, self.genome_dev,
                                  contact_fn=self.contact_fn)
            else:
                self.state, self._bond_plan = run_steps(
                    self.state, self.params, self.genome_dev, c,
                    contact_fn=self.contact_fn,
                    bond_plan=self._plan_for_state(), return_plan=True)
            remaining -= c

    def run(self, n_steps: int) -> float:
        """Run n steps; returns physics steps per second (host clock
        around work that ends in a device synchronise)."""
        t0 = time.perf_counter()
        self.step(n_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self._steps_per_sec = n_steps / dt if dt > 0 else float("inf")
        return self._steps_per_sec

    # -- capacity and genome -------------------------------------------------

    def _maybe_grow(self) -> None:
        """Grow capacity when the population could exceed it next step
        (the growth policy of cs:788-792: max(needed, 2×current))."""
        active = int(self.state.active_count)
        cap = self.state.capacity
        if cap - active > max(1, self.params.max_splits_per_step // 2):
            return
        self.resize(max(active + self.params.max_splits_per_step, cap * 2))

    def resize(self, new_capacity: int) -> None:
        """Migrate the state into a larger fixed capacity
        (ResizeParticleBuffers, cs:1162-1222): a fresh population at the
        new capacity with the old rows copied over; the bond table, the
        pending splits, the drag input, the counters and the PRNG key carry
        over unchanged. The carried bond plan is rebuilt at the next chunk
        (its key holds the capacity)."""
        if new_capacity <= self.state.capacity:
            return
        old = self.state
        fresh = self._fresh(new_capacity)
        n = old.capacity
        upd = {}
        for f in dataclasses.fields(SimState):
            ov, nv = getattr(old, f.name), getattr(fresh, f.name)
            if f.name in _CARRIED:
                upd[f.name] = ov
            else:
                nv[:n] = ov
                upd[f.name] = nv
        self.state = SimState(**upd)

    def on_genome_changed(self, genome: Genome) -> None:
        """Hot-reload hook: re-initialise the particles under the new genome
        at the current capacity (cs:357-367). The carried bond plan stays,
        as in the JAX package: the capacities are unchanged, and a stale
        plan is valid."""
        self.genome = genome.validate_for_simulation()
        self.genome_dev = self.genome.to_device(self.device)
        self.state = self._fresh(self.state.capacity)

    # -- interaction ---------------------------------------------------------

    def pick(self, ray_origin, ray_dir) -> int:
        """Ray-sphere pick over active particles with max_radius as the
        pick radius (cs:977-1013). Returns the slot or -1."""
        n = int(self.state.active_count)
        if n == 0:
            return -1
        pos = self.state.pos[:n].cpu().numpy()
        o = np.asarray(ray_origin, np.float32)
        d = np.asarray(ray_dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-12)
        r = self.params.max_radius
        oc = pos - o
        tca = oc @ d
        d2 = np.einsum("ij,ij->i", oc, oc) - tca * tca
        hit = (tca >= 0) & (d2 <= r * r)
        t = tca - np.sqrt(np.maximum(r * r - d2, 0.0))
        t = np.where(hit, t, np.inf)
        best = int(np.argmin(t))
        if not np.isfinite(t[best]):
            return -1
        # Sticky selection (lastSelectedParticleID, cs:125-126).
        self.last_selected = best
        return best

    def set_drag(self, slot: int, target, strength: float = 100.0) -> None:
        """Engage the drag force on a particle (strength 100 while held,
        cs:1027-1032)."""
        f32 = dict(dtype=torch.float32, device=self.device)
        d = self.state.drag_input
        self.state = self.state.replace_fields(drag_input=d.replace_fields(
            selected_slot=torch.tensor(slot, dtype=torch.int32,
                                       device=self.device),
            target=torch.tensor(np.asarray(target, np.float32), **f32),
            strength=torch.tensor(strength, **f32)))

    def clear_drag(self) -> None:
        self.set_drag(-1, (0.0, 0.0, 0.0), 0.0)

    # -- observability ---------------------------------------------------------

    def particle_ids(self) -> list[str]:
        """Formatted 'PP.UU.C' ids of the active particles (cs:178-191)."""
        n = int(self.state.active_count)
        cols = torch.stack([self.state.parent_uid[:n], self.state.uid[:n],
                            self.state.child_type[:n]]).cpu().numpy()
        return [formatted_id(*cols[:, i]) for i in range(n)]

    def bond_lines(self) -> list[dict]:
        """Bond visuals (CAM:245-304): per active bond, endpoint positions,
        midpoint, zone colours of each half (with the reference's A/B colour
        swap, CAM:275-276), world-space anchor endpoints and the
        child-to-child flag. One host copy per column, then numpy."""
        st = self.state
        b = st.bonds
        active = b.active.cpu().numpy()
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            return []
        pos = st.pos.cpu().numpy()
        rot = st.rot.cpu().numpy()
        slot_a = b.slot_a.cpu().numpy()[idx]
        slot_b = b.slot_b.cpu().numpy()[idx]
        zone_a = b.zone_a.cpu().numpy()[idx]
        zone_b = b.zone_b.cpu().numpy()[idx]
        aa = b.anchor_a.cpu().numpy()[idx]
        ab = b.anchor_b.cpu().numpy()[idx]
        c2c = b.child_to_child.cpu().numpy()[idx]

        def rot_np(q, v):
            # numpy form of core.quat.rotate (compute:373-377)
            u, w = q[:, :3], q[:, 3:4]
            return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)

        pa = pos[slot_a]
        pb = pos[slot_b]
        anchor_a = pa + rot_np(rot[slot_a], aa)
        anchor_b = pb + rot_np(rot[slot_b], ab)
        mid = (pa + pb) * 0.5
        # Inspector defaults: zoneA green, zoneB blue, zoneC red — with the
        # swap, ZoneB renders green and ZoneA blue (CAM:275).
        zone_color = {1: (0, 1, 0), 0: (0, 0, 1), 2: (1, 0, 0)}
        return [{
            "a": pa[j].tolist(), "b": pb[j].tolist(),
            "midpoint": mid[j].tolist(),
            "color_a": zone_color[int(zone_a[j])],
            "color_b": zone_color[int(zone_b[j])],
            "anchor_a": anchor_a[j].tolist(),
            "anchor_b": anchor_b[j].tolist(),
            "child_to_child": bool(c2c[j]),
        } for j in range(idx.size)]

    def forward_axes(self) -> np.ndarray:
        """Per-particle +Z body axis in world space (the reference's
        forward-axis dot, InstancedParticles.shader:171-175)."""
        n = int(self.state.active_count)
        ez = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        return quat.rotate(self.state.rot[:n], ez).cpu().numpy()

    def metrics(self) -> dict:
        """Structured metrics (SURVEY §5.5)."""
        st = self.state
        n = int(st.active_count)
        vel = st.vel[:n].cpu().numpy()
        mass = st.mass[:n].cpu().numpy()
        ke = float(0.5 * np.sum(mass * np.sum(vel * vel, axis=-1)))
        return {
            "step": int(st.step_count),
            "active_particles": n,
            "bond_count": int(st.bonds.active.sum()),
            "kinetic_energy": ke,
            "max_speed": (float(np.max(np.linalg.norm(vel, axis=-1)))
                          if n else 0.0),
            "overflow": int(st.overflow),
            "steps_per_sec": self._steps_per_sec,
        }

    # -- checkpoint / resume -------------------------------------------------

    def save(self, path: str) -> None:
        """A checkpoint in the JAX package's format (engine/checkpoint.py)
        with this sim's seed and rng mode."""
        from sph_tpu_torch.engine.checkpoint import save_checkpoint

        save_checkpoint(path, self.state, self.params, self.genome,
                        sim_meta={"seed": self.seed,
                                  "rng_mode": self.rng_mode})

    @classmethod
    def load(cls, path: str, device="cuda", mesh=None) -> "Simulation":
        """Resume from a checkpoint written by either package, on one
        device or onto a mesh (checkpoints are mesh-agnostic). The seed
        and rng mode come back from its header (older files without them
        fall back to the constructor's defaults), so a later resize() draws
        the grown rows from the same stream as a run never
        checkpointed."""
        from sph_tpu_torch.engine.checkpoint import load_checkpoint

        if mesh is not None:
            device = mesh.device
        state, params, genome, meta = load_checkpoint(path, device=device)
        sim = cls.__new__(cls)
        sim._setup(genome, params, int(meta.get("seed", 0)),
                   str(meta.get("rng_mode", "jax")), False, device,
                   state=state, mesh=mesh)
        return sim
