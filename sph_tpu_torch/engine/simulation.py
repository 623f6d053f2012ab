"""Host-facing colony Simulation API — the counterpart of
sph_tpu.engine.simulation.Simulation (single device): init (Start,
cs:211-242), stepping, interactive drag (cs:975-1034), ids, bond visuals and
metrics. Still to port (ROADMAP A14): resize and auto-grow, genome
hot-reload, checkpoints and the device mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.init import init_particles
from sph_tpu_torch.core.types import Genome, SimParams, SimState, formatted_id
from sph_tpu_torch.engine.step import run_steps


class Simulation:
    """A running colony simulation.

    >>> sim = Simulation(genome, SimParams(capacity=64))  # on the card
    >>> sim.run(600)
    >>> sim.metrics()
    """

    def __init__(self, genome: Genome, params: SimParams, seed: int = 0,
                 rng_mode: str = "jax", device="cuda"):
        """A fresh population from init_particles; to start from another
        state (a bonded colony, a state carried across from the JAX
        package), assign `sim.state` a SimState on `sim.device`."""
        self.genome = genome.validate_for_simulation()
        self.params = params
        self.seed = seed
        self.rng_mode = rng_mode
        self.device = torch.device(device)
        self.genome_dev = self.genome.to_device(self.device)
        self.state: SimState = init_particles(
            params, self.genome_dev, n_modes=len(self.genome.modes),
            initial_mode=self.genome.initial_mode_index,
            capacity=params.capacity, seed=seed, rng_mode=rng_mode,
            device=self.device)
        self._steps_per_sec = float("nan")
        self.last_selected = -1   # lastSelectedParticleID (cs:125)

    # -- stepping ------------------------------------------------------------

    def step(self, n: int = 1, dt=None) -> None:
        """Advance n physics steps. dt: a scalar for all n steps or a
        length-n sequence (variable-dt compat, cs:246); None = params.dt."""
        dts = None
        if dt is not None:
            dts = np.broadcast_to(np.asarray(dt, np.float32), (n,))
        self.state = run_steps(self.state, self.params, self.genome_dev, n,
                               dts=dts)

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

