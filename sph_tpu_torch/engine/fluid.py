"""Host-facing fluid simulation API — the counterpart of
sph_tpu.engine.fluid.FluidSimulation: scene setup, stepping on the dense
engine (on one device, or sharded over a mesh of ranks), pick and drag,
metrics, a restart from a snapshot held on the device, checkpoints in the
JAX package's format (npz of the DenseFluidState fields plus a JSON
header), so a checkpoint written by either package, on a mesh or not,
loads in the other, and on-device rendering."""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from sph_tpu_torch.sph.dense import (
    DenseFluidState,
    make_dense_spec,
    make_dense_step,
    pack,
    unpack,
)
from sph_tpu_torch.sph.model import FluidDrag, SPHParams, SPHState
from sph_tpu_torch.utils.convert import params_from_jax, state_from_numpy
from sph_tpu_torch.utils.profiling import span


def tank_camera(params: SPHParams):
    """render_frame's default camera: above and in front of the tank,
    looking at its centre from 1.6 × its diagonal."""
    from sph_tpu_torch.render.camera import Camera

    lo = np.asarray(params.bounds_min)
    hi = np.asarray(params.bounds_max)
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    camera = Camera(position=np.array(
        [center[0], center[1] + 0.3 * extent,
         center[2] - 1.6 * extent], np.float32))
    camera.focus_on(center, distance=1.6 * extent)
    return camera


class FluidSimulation:
    """A running fluid simulation on the dense engine.

    >>> sim = FluidSimulation.from_scene("dam_break_3d", n_target=262144,
    ...                                  device="cuda")
    >>> sim.run(600)
    >>> sim.metrics()

    mesh: a parallel.dist.Mesh (1D ring or 2D): every rank of it builds the
    simulation from the same state and then holds and steps its own block
    on the mesh's device (spatial domain decomposition with halo exchange,
    BASELINE config[4]); the result is bitwise the single-device run's.
    On a mesh, `particles`, `pick`, `render_frame`, `metrics` and `save`
    are collective: every rank calls them.
    """

    def __init__(self, state: SPHState, params: SPHParams,
                 substeps: int = 10, device="cuda", mesh=None):
        self.params = params
        self.mesh = mesh
        self.spec = make_dense_spec(
            params, k=params.dense_k, cell_factor=params.cell_factor
        )
        self._start(pack(state, params, self.spec,
                         device="cpu" if mesh else device), 0, substeps)

    def _start(self, dstate: DenseFluidState, step: int, substeps: int):
        """Step functions and host state; on a mesh, `dstate` is the global
        state and this rank keeps its block."""
        if self.mesh is None:
            self._step_fn = make_dense_step(self.params, self.spec, substeps)
        else:
            from sph_tpu_torch.parallel.dist import (
                make_sharded_step,
                shard_dense_state,
            )

            dstate = shard_dense_state(dstate, self.mesh, self.spec,
                                       self.params)
            self._step_fn = make_sharded_step(self.params, self.spec,
                                              self.mesh, substeps)
        self.dstate = dstate
        self.device = dstate.px.device
        self.substeps = substeps
        # Host mirror of dstate.step_count: the rebin cadence is decided
        # from it, so stepping never waits for the device.
        self._step = step
        self._steps_per_sec = float("nan")
        self._drag = None

    @classmethod
    def from_scene(cls, scene: str, substeps: int = 10, device="cuda",
                   mesh=None, **scene_kwargs):
        from sph_tpu_torch.sph import scenes

        builder = getattr(scenes, scene)
        state, params = builder(**scene_kwargs)
        return cls(state, params, substeps=substeps, device=device,
                   mesh=mesh)

    # -- stepping -------------------------------------------------------------

    def run(self, n_steps: int) -> float:
        """Run ≥ n_steps (rounded up to substep blocks); returns steps/sec."""
        blocks = max(1, -(-n_steps // self.substeps))
        t0 = time.perf_counter()
        for _ in range(blocks):
            self.dstate = self._step_fn(self.dstate, self._step, self._drag)
            self._step += self.substeps
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_done = blocks * self.substeps
        dt = time.perf_counter() - t0
        self._steps_per_sec = n_done / dt if dt > 0 else float("inf")
        return self._steps_per_sec

    # -- interaction ----------------------------------------------------------

    def pick(self, ray_origin, ray_dir):
        """Nearest fluid particle along a ray (pick radius h) — returns its
        world position (the drag anchor) or None."""
        p = self.particles()[0]
        if not len(p):
            return None
        o = np.asarray(ray_origin, np.float32)
        d = np.asarray(ray_dir, np.float32)
        d = d / max(np.linalg.norm(d), 1e-12)
        oc = p - o
        tca = oc @ d
        d2 = np.einsum("ij,ij->i", oc, oc) - tca * tca
        r = self.params.h
        hit = (tca >= 0) & (d2 <= r * r)
        if not hit.any():
            return None
        t = np.where(hit, tca, np.inf)
        return p[int(np.argmin(t))]

    def set_drag(self, center, target, radius=None,
                 strength: float = 100.0) -> None:
        """Engage the space-anchored drag sphere (model.FluidDrag):
        particles within `radius` (default 3h) of `center` are pulled
        toward `target`."""
        if self.mesh is not None:
            raise NotImplementedError("interactive drag is single-device "
                                      "for now")
        if radius is None:
            radius = 3.0 * self.params.h
        self._drag = FluidDrag.at(center, target, radius, strength,
                                  device=self.device)

    def clear_drag(self) -> None:
        self._drag = None

    # -- observability --------------------------------------------------------

    def _global_state(self) -> DenseFluidState:
        """The whole state: on a mesh, gathered from every rank."""
        if self.mesh is None:
            return self.dstate
        from sph_tpu_torch.parallel.dist import unshard_dense_state

        return unshard_dense_state(self.dstate, self.mesh, self.spec)

    def particles(self):
        """(pos, vel, rho, prs) numpy arrays of alive particles."""
        pos, vel, rho, prs, mask = unpack(self._global_state())
        m = mask.cpu().numpy()
        return tuple(a.cpu().numpy()[m] for a in (pos, vel, rho, prs))

    def counters(self) -> dict:
        """The step's device counters as 0-dim integer tensors on the
        simulation's device, returned without waiting for it: the state's
        `dropped` (particles the rebin could not place) and `clamped`
        (lanes the speed limit held); `rebin_peak`, the most particles
        that sought one cell at a rebin on this device since
        `ops.reset_rebin_peak()` (`ops.rebin_peak`); and `pushed`, the
        occupied lanes the obstacles' push acted on, summed over the steps
        on this device since `ops.reset_obstacle_pushed()`
        (`ops.obstacle_pushed`, int64)."""
        from sph_tpu_torch.ops import obstacle_pushed, rebin_peak

        return {"dropped": self.dstate.dropped,
                "clamped": self.dstate.clamped,
                "rebin_peak": rebin_peak(self.device),
                "pushed": obstacle_pushed(self.device)}

    def metrics(self) -> dict:
        pos, vel, rho, _ = self.particles()
        ke = float(
            0.5 * self.params.particle_mass * np.sum(np.sum(vel ** 2, -1))
        )
        return {
            "step": int(self.dstate.step_count),
            "n_particles": int(pos.shape[0]),
            "kinetic_energy": ke,
            "mean_density": float(rho.mean()) if len(rho) else 0.0,
            "max_density": float(rho.max()) if len(rho) else 0.0,
            "max_speed": (float(np.linalg.norm(vel, axis=-1).max())
                          if len(vel) else 0.0),
            "dropped": int(self.dstate.dropped),
            "clamped": int(self.dstate.clamped),
            "steps_per_sec": self._steps_per_sec,
        }

    def render_frame(self, path: str | None = None, camera=None,
                     width: int = 800, height: int = 450):
        """On-device point splat of the current state ([H, W, 3] f32 on
        the sim's device); optionally saved as a PNG."""
        from sph_tpu_torch.render.splat import render_points, save_image

        if camera is None:
            camera = tank_camera(self.params)
        pos, _, _, _, mask = unpack(self._global_state())
        # Screen-space radius scaling (projected-size splat classes): SPH
        # particles render at their smoothing-scale footprint h/2.
        img = render_points(
            pos, camera.view_params(), width=width, height=height, mask=mask,
            radius=torch.full((pos.shape[0],), self.params.h * 0.5,
                              dtype=torch.float32, device=pos.device),
        )
        if path:
            save_image(img, path)
        return img

    # -- device-held restart --------------------------------------------------

    def snapshot(self) -> dict:
        """The running state held on its device: a clone of every
        DenseFluidState tensor, the host's step mirror and the substeps.
        Single device only (`restore` puts it back)."""
        if self.mesh is not None:
            raise NotImplementedError("snapshot is single-device for now")
        with span("sph.fluid.snapshot"):
            return {"state": {f.name: getattr(self.dstate, f.name).clone()
                              for f in dataclasses.fields(DenseFluidState)},
                    "step": self._step, "substeps": self.substeps}

    def restore(self, snap: dict) -> None:
        """Back to a `snapshot` of this simulation: device copies of its
        tensors (the snapshot stays usable), with the same step function
        and no host copy. The counters outside the state
        (`ops.rebin_peak`, `ops.obstacle_pushed`) run on."""
        if self.mesh is not None:
            raise NotImplementedError("restore is single-device for now")
        if snap["substeps"] != self.substeps:
            raise ValueError(f"the snapshot steps {snap['substeps']} "
                             f"substeps a call, this simulation "
                             f"{self.substeps}")
        with span("sph.fluid.restore"):
            self.dstate = DenseFluidState(
                **{k: t.clone() for k, t in snap["state"].items()})
        self._step = snap["step"]

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path: str) -> None:
        """The whole state (on a mesh: gathered, and written by rank 0;
        every rank returns once the file is complete)."""
        d = self._global_state()
        if self.mesh is None or self.mesh.rank == 0:
            flat = {
                f.name: getattr(d, f.name).cpu().numpy()
                for f in dataclasses.fields(DenseFluidState)
            }
            header = json.dumps({
                "params": dataclasses.asdict(self.params),
                "substeps": self.substeps,
            })
            np.savez_compressed(path, __header__=header, **flat)
        if self.mesh is not None:
            self.mesh.barrier()

    @classmethod
    def load(cls, path: str, device="cuda", mesh=None) -> "FluidSimulation":
        """Resume from a checkpoint written by this class or by the JAX
        package's FluidSimulation.save — on one device, or onto a mesh
        (checkpoints hold the whole state whatever wrote them)."""
        with np.load(path, allow_pickle=False) as data:
            header = json.loads(str(data["__header__"]))
            flat = {k: data[k] for k in data.files if k != "__header__"}
        # Checkpoints written before the clamp diagnostic existed lack it.
        flat.setdefault("clamped", np.int32(0))
        sim = cls.__new__(cls)
        sim.params = params_from_jax(header["params"])
        sim.mesh = mesh
        sim.spec = make_dense_spec(
            sim.params, k=sim.params.dense_k,
            cell_factor=sim.params.cell_factor,
        )
        sim._start(state_from_numpy(flat, "cpu" if mesh else device),
                   int(flat["step_count"]), header["substeps"])
        return sim
