"""Weakly-compressible SPH (WCSPH) fluid model — the counterpart of
sph_tpu.sph.model for the dense path: parameters, flat state, interactive
drag, SDF obstacles, the Tait EOS and box walls.

Scalars: a Python float meeting an f32 tensor is rounded to f32 at the op,
exactly where JAX rounds its weak-typed scalars.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


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


def obstacle_accel(pos: torch.Tensor, params: SPHParams) -> torch.Tensor:
    """Penalty acceleration pushing particles out of obstacle interiors
    (plus a thin boundary layer of h/2)."""
    acc = torch.zeros_like(pos)
    for ob in params.obstacles:
        sd, normal = sdf_value_grad(pos, ob)
        pen = torch.clamp_min(params.h * 0.5 - sd, 0.0)
        acc = acc + normal * (pen * params.obstacle_stiffness)[..., None]
    return acc


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
