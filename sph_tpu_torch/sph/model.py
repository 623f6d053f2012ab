"""Weakly-compressible SPH (WCSPH) fluid model — the counterpart of
sph_tpu.sph.model: parameters, flat state, interactive drag, SDF obstacles,
the Tait EOS and box walls, and the sort+gather grid path (`sph_step`,
`make_sph_step`, config[0]) with its brute-force twins.

Scalars: a Python float meeting an f32 tensor is rounded to f32 at the op,
exactly where JAX rounds its weak-typed scalars.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from sph_tpu_torch.ops.grid import (
    GridSpec,
    cell_coords,
    row_blocks,
    sort_by_cell,
    stencil_candidates_sorted,
)
from sph_tpu_torch.sph import kernels as K


@dataclass(frozen=True)
class SPHParams:
    """Static fluid parameters (same fields as the JAX SPHParams, so a
    checkpoint header round-trips between the packages)."""

    ndim: int = 3
    h: float = 0.1                    # support radius
    rest_density: float = 1000.0
    particle_mass: float = 1.0
    sound_speed: float = 20.0         # Tait EOS stiffness: B = ρ0·c²/γ
    gamma: float = 7.0
    viscosity: float = 0.1            # dynamic viscosity μ
    gravity: float = 9.81
    dt: float = 4e-4
    bounds_min: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bounds_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    boundary_damping: float = 0.5     # velocity restitution on wall hit
    cell_capacity: int = 16
    row_block: int = 4096
    # Dense-grid engine knobs (sph_tpu_torch.sph.dense): slots per cell,
    # cell size as a multiple of h, hand-written kernels for the sweeps and
    # the rebin (the field keeps its JAX name because checkpoints carry it),
    # and rebin cadence.
    dense_k: int = 8
    cell_factor: float = 1.25
    use_pallas: bool = True
    rebin_every: int = 6
    # SDF obstacles: tuple of (kind, params...) — see sdf_value_grad().
    obstacles: tuple = ()
    obstacle_stiffness: float = 3e4

    @property
    def tait_b(self) -> float:
        return self.rest_density * self.sound_speed ** 2 / self.gamma

    def grid_spec(self) -> GridSpec:
        """The sort+gather grid: cell size h (one 27-cell stencil covers the
        kernel support) and one cell of margin so wall-adjacent particles
        never clamp across; one cell deep in 2D."""
        lo, hi = self.bounds_min, self.bounds_max
        dims = []
        for a in range(3):
            extent = hi[a] - lo[a]
            dims.append(max(1, int(-(-extent // self.h)) + 2)
                        if extent > 0 else 1)
        if self.ndim == 2:
            dims[2] = 1
        return GridSpec(
            dim=tuple(dims),
            cell_size=self.h,
            origin=(lo[0] - self.h, lo[1] - self.h,
                    lo[2] - (self.h if self.ndim == 3 else 0.0)),
            cell_capacity=self.cell_capacity,
        )

    def replace(self, **kw) -> "SPHParams":
        return dataclasses.replace(self, **kw)


@dataclass
class SPHState:
    """Flat SoA fluid state: pos/vel [N, 3] (z = 0 in 2D), density and
    pressure [N], int32 counters."""

    pos: torch.Tensor
    vel: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    step_count: torch.Tensor
    bin_overflow: torch.Tensor

    def to(self, device) -> "SPHState":
        """The state on `device` (itself if every field is there)."""
        return SPHState(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    @staticmethod
    def from_positions(pos: torch.Tensor, params: SPHParams) -> "SPHState":
        pos = torch.as_tensor(pos).to(torch.float32)
        n, dev = pos.shape[0], pos.device
        i32 = dict(dtype=torch.int32, device=dev)
        return SPHState(
            pos=pos,
            vel=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            density=torch.full((n,), params.rest_density,
                               dtype=torch.float32, device=dev),
            pressure=torch.zeros(n, dtype=torch.float32, device=dev),
            step_count=torch.zeros((), **i32),
            bin_overflow=torch.zeros((), **i32),
        )


@dataclass
class FluidDrag:
    """Space-anchored interactive drag (sph_tpu.sph.model.FluidDrag): every
    particle within `radius` of `center` gets the impulse form
    (target − pos)·strength·dt/mass. strength ≤ 0 disables it."""

    center: torch.Tensor     # [3]
    radius: torch.Tensor     # scalar
    target: torch.Tensor     # [3]
    strength: torch.Tensor   # scalar; <= 0 ⇒ no-op

    @staticmethod
    def at(center, target, radius, strength=100.0,
           device="cuda") -> "FluidDrag":
        f32 = dict(dtype=torch.float32, device=device)
        return FluidDrag(
            center=torch.as_tensor(center, **f32),
            radius=torch.as_tensor(radius, **f32),
            target=torch.as_tensor(target, **f32),
            strength=torch.as_tensor(strength, **f32),
        )


# ---------------------------------------------------------------------------
# SDF obstacles (config[3]): signed-distance colliders with penalty forces.
# ---------------------------------------------------------------------------


def sdf_value_grad(pos: torch.Tensor, obstacle):
    """Signed distance + outward normal for one obstacle.

    Obstacle specs (static python data):
      ("sphere", (cx, cy, cz), r)
      ("box", (cx, cy, cz), (hx, hy, hz))
      ("cylinder_z", (cx, cy), r)    — infinite along z
    """
    kind = obstacle[0]
    norm = torch.linalg.vector_norm
    f32 = dict(dtype=torch.float32, device=pos.device)
    if kind == "sphere":
        c = torch.as_tensor(obstacle[1], **f32)
        r = obstacle[2]
        d = pos - c
        dist = norm(d, dim=-1)
        return dist - r, d / torch.clamp_min(dist, 1e-9)[..., None]
    if kind == "box":
        c = torch.as_tensor(obstacle[1], **f32)
        half = torch.as_tensor(obstacle[2], **f32)
        q = torch.abs(pos - c) - half
        outside = torch.clamp_min(q, 0.0)
        dist_out = norm(outside, dim=-1)
        dist_in = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
        sd = dist_out + dist_in
        grad_out = (torch.sign(pos - c) * outside
                    / torch.clamp_min(dist_out, 1e-9)[..., None])
        ax = torch.argmax(q, dim=-1)
        grad_in = torch.sign(pos - c) * torch.nn.functional.one_hot(
            ax, 3).to(pos.dtype)
        return sd, torch.where((dist_out > 0)[..., None], grad_out, grad_in)
    if kind == "cylinder_z":
        c = torch.as_tensor(obstacle[1], **f32)
        r = obstacle[2]
        d = pos[..., :2] - c
        dist = norm(d, dim=-1)
        n2 = d / torch.clamp_min(dist, 1e-9)[..., None]
        normal = torch.cat([n2, torch.zeros_like(pos[..., 2:3])], dim=-1)
        return dist - r, normal
    raise ValueError(f"unknown obstacle kind {kind!r}")


def obstacle_push(pos: torch.Tensor, params: SPHParams):
    """(acceleration, band): `obstacle_accel`'s acceleration, and True
    where some obstacle's penetration is positive, i.e. where its push acts
    (the position lies within h/2 of its surface, or inside it)."""
    acc = torch.zeros_like(pos)
    band = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for ob in params.obstacles:
        sd, normal = sdf_value_grad(pos, ob)
        pen = torch.clamp_min(params.h * 0.5 - sd, 0.0)
        acc = acc + normal * (pen * params.obstacle_stiffness)[..., None]
        band = band | (pen > 0.0)
    return acc, band


def obstacle_accel(pos: torch.Tensor, params: SPHParams) -> torch.Tensor:
    """Penalty acceleration pushing particles out of obstacle interiors
    (plus a thin boundary layer of h/2)."""
    return obstacle_push(pos, params)[0]


def eos_pressure(rho: torch.Tensor, params: SPHParams) -> torch.Tensor:
    """Tait equation of state, clamped ≥ 0 against tensile instability.
    `** gamma` is f32 pow; backends differ in its last ulp (JAX's own jit
    and eager paths differ by several), amplified by the `− 1`."""
    p = params.tait_b * ((rho / params.rest_density) ** params.gamma - 1.0)
    return torch.clamp_min(p, 0.0)


def apply_boundaries(pos, vel, params: SPHParams):
    """Box walls: clamp position, damp + reflect the normal velocity."""
    lo = list(params.bounds_min)
    hi = list(params.bounds_max)
    if params.ndim == 2:
        lo[2], hi[2] = -1.0, 1.0
    lo = torch.tensor(lo, dtype=torch.float32, device=pos.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=pos.device)
    hit = (pos < lo) | (pos > hi)
    pos = torch.clamp(pos, lo, hi)
    vel = torch.where(hit, -params.boundary_damping * vel, vel)
    return pos, vel


# ---------------------------------------------------------------------------
# The sort+gather grid path (config[0]): density and force passes over
# particle rows sorted by cell, each row summing its [27·K] candidates.
# ---------------------------------------------------------------------------


def _row_blocked(N: int, row_block: int, block_fn, device):
    """block_fn over the row blocks (`ops.grid.row_blocks`), concatenated
    and cut to N rows (the blocks bound the [R, 27K] candidate tensors)."""
    return torch.cat([block_fn(rows) for rows in
                      row_blocks(N, row_block, device)])[:N]


def _density_sorted(pos, coords, bins, spec, params: SPHParams):
    """ρ over SORTED particle rows (self term included via the r² = 0
    lane)."""
    N = pos.shape[0]
    h2 = params.h * params.h

    def block(rows):
        cand = stencil_candidates_sorted(coords[rows], bins, spec)
        cj = torch.clamp(cand, 0, N - 1).long()
        d = pos[rows][:, None, :] - pos[cj]
        r2 = torch.sum(d * d, dim=-1)
        w = torch.where((cand >= 0) & (r2 < h2),
                        K.w_poly6(r2, params.h, params.ndim), 0.0)
        return params.particle_mass * torch.sum(w, dim=1)

    return torch.clamp_min(
        _row_blocked(N, params.row_block, block, pos.device), 1e-6)


def _accel_sorted(pos, vel, rho, p, coords, bins, spec, params: SPHParams):
    """Pressure + viscosity acceleration over SORTED rows."""
    N = pos.shape[0]
    h = params.h
    m = params.particle_mass
    p_over_rho2 = p / (rho * rho)

    def block(rows):
        cand = stencil_candidates_sorted(coords[rows], bins, spec)
        cj = torch.clamp(cand, 0, N - 1).long()
        d = pos[rows][:, None, :] - pos[cj]
        r2 = torch.sum(d * d, dim=-1)
        r = torch.sqrt(torch.clamp_min(r2, 1e-18))
        near = ((cand >= 0) & (r2 < h * h) & (r2 > 1e-16))[..., None]

        grad = K.grad_w_spiky(d, r, h, params.ndim)
        pij = p_over_rho2[rows][:, None] + p_over_rho2[cj]
        a_press = -m * torch.sum(
            torch.where(near, grad * pij[..., None], 0.0), dim=1)
        lap = K.lap_w_viscosity(r, h, params.ndim)
        dv = vel[cj] - vel[rows][:, None, :]
        a_visc = params.viscosity * m * torch.sum(
            torch.where(near,
                        dv * (lap / (rho[rows][:, None] * rho[cj]))[..., None],
                        0.0),
            dim=1)
        return a_press + a_visc

    return _row_blocked(N, params.row_block, block, pos.device)


def _external_accel(pos, acc, params: SPHParams):
    """Gravity, the obstacles' push, and z held at 0 in 2D."""
    g = torch.zeros(3, dtype=torch.float32, device=pos.device)
    g[1] = -params.gravity
    acc = acc + g
    if params.obstacles:
        acc = acc + obstacle_accel(pos, params)
    if params.ndim == 2:
        acc = acc.clone()
        acc[:, 2] = 0.0
    return acc


def _unsort(order, x):
    """Rows of x (in sorted order) back to input order."""
    out = torch.empty_like(x)
    out[order] = x
    return out


def compute_density(state: SPHState, params: SPHParams):
    """(ρ in input particle order, bin overflow): the sorted pipeline, then
    the inverse permutation."""
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos_s = state.pos[order]
    rho_s = _density_sorted(pos_s, cell_coords(pos_s, spec), bins, spec,
                            params)
    return _unsort(order, rho_s), bins.overflow


def compute_accel(state: SPHState, params: SPHParams) -> torch.Tensor:
    """Acceleration in input particle order (sorted pipeline inside)."""
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos_s, vel_s = state.pos[order], state.vel[order]
    rho_s, p_s = state.density[order], state.pressure[order]
    acc_s = _accel_sorted(pos_s, vel_s, rho_s, p_s, cell_coords(pos_s, spec),
                          bins, spec, params)
    return _unsort(order, _external_accel(pos_s, acc_s, params))


def sph_step(state: SPHState, params: SPHParams) -> SPHState:
    """One WCSPH step: sort by cell → density → EOS → forces → symplectic
    Euler → walls. Fluid particles carry no identity, so the cell-sort
    permutation is kept: the output state is in sorted order, as the JAX
    package's is."""
    spec = params.grid_spec()
    order, bins = sort_by_cell(state.pos, spec)
    pos = state.pos[order]
    vel = state.vel[order]
    coords = cell_coords(pos, spec)

    rho = _density_sorted(pos, coords, bins, spec, params)
    p = eos_pressure(rho, params)
    acc = _accel_sorted(pos, vel, rho, p, coords, bins, spec, params)
    acc = _external_accel(pos, acc, params)

    vel = vel + acc * params.dt
    pos = pos + vel * params.dt
    pos, vel = apply_boundaries(pos, vel, params)
    return SPHState(
        pos=pos, vel=vel, density=rho, pressure=p,
        step_count=state.step_count + 1,
        bin_overflow=state.bin_overflow + bins.overflow,
    )


def make_sph_step(params: SPHParams, substeps: int = 1, device="cuda"):
    """`f(state) -> state` advancing `substeps` steps of `sph_step` in a
    host loop on `device` (the state is moved there first if it lies
    elsewhere) — the JAX package's jitted scan of the same steps."""
    device = torch.device(device)

    def f(state: SPHState) -> SPHState:
        state = state.to(device)
        for _ in range(substeps):
            state = sph_step(state, params)
        return state

    return f


# -- brute-force reference paths (executable spec; BASELINE config[0]) -------


def compute_density_bruteforce(state: SPHState, params: SPHParams):
    d = state.pos[:, None, :] - state.pos[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    w = torch.where(r2 < params.h ** 2,
                    K.w_poly6(r2, params.h, params.ndim), 0.0)
    return torch.clamp_min(params.particle_mass * torch.sum(w, dim=1), 1e-6)


def compute_accel_bruteforce(state: SPHState, params: SPHParams):
    h = params.h
    m = params.particle_mass
    rho, p = state.density, state.pressure
    pr2 = p / (rho * rho)
    d = state.pos[:, None, :] - state.pos[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(torch.clamp_min(r2, 1e-18))
    near = ((r2 < h * h) & (r2 > 1e-16))[..., None]
    grad = K.grad_w_spiky(d, r, h, params.ndim)
    a_press = -m * torch.sum(
        torch.where(near, grad * (pr2[:, None] + pr2[None, :])[..., None],
                    0.0),
        dim=1)
    lap = K.lap_w_viscosity(r, h, params.ndim)
    dv = state.vel[None, :, :] - state.vel[:, None, :]
    a_visc = params.viscosity * m * torch.sum(
        torch.where(near,
                    dv * (lap / (rho[:, None] * rho[None, :]))[..., None],
                    0.0),
        dim=1)
    return _external_accel(state.pos, a_press + a_visc, params)
