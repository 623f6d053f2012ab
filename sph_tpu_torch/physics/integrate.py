"""Motion and rotation integration (UpdateMotion / UpdateRotation,
SimulateParticles.compute:326-357, :379-408) — the counterpart of
sph_tpu.physics.integrate, with the same mask-parameterised cores."""

from __future__ import annotations

import torch

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.quat import cross, dot, norm
from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.physics.contact import alive_mask


def _exp(x):
    """exp of a tensor, or of a Python float rounded to f32 first (the
    JAX version exponentiates a weak-typed f32 scalar)."""
    if isinstance(x, torch.Tensor):
        return torch.exp(x)
    return float(torch.exp(torch.tensor(x, dtype=torch.float32)))


def motion_core(pos, vel, ang, radius, inertia, dragc, mask,
                params: SimParams, dt):
    """UpdateMotion on [..., 3] arrays under an update mask: exponential
    damping, position integration, spherical boundary with reflection and
    boundary-friction torque (:326-357). Unmasked rows keep their inputs
    bit for bit. Returns (pos, vel, ang)."""
    m = mask[..., None]

    lin_damp = torch.exp(-dragc * params.global_drag_multiplier * dt)
    ang_damp = _exp(-params.torque_damping * dt)

    vel_n = vel * lin_damp[..., None]
    ang_n = ang * ang_damp
    pos_n = pos + vel_n * dt

    dist = norm(pos_n)
    outside = dist > params.spawn_radius
    nrm = pos_n / torch.clamp(dist, min=1e-12)[..., None]

    pos_b = nrm * params.spawn_radius
    # reflect(v, n) = v − 2(v·n)n (:345)
    v_dot_n = dot(vel_n, nrm, keepdim=True)
    vel_b = vel_n - 2.0 * v_dot_n * nrm

    tangential = vel_b - dot(vel_b, nrm, keepdim=True) * nrm
    # The reference adds 1e-6 to every component before normalising (:348).
    fr = tangential + 1e-6
    friction_dir = fr / torch.clamp(norm(fr, keepdim=True), min=1e-20)
    friction_mag = norm(tangential) * params.boundary_friction
    eff_r = radius * params.rolling_contact_radius_multiplier
    # cross(−n·r, −f̂·m) == cross(n·r, f̂·m) (:352)
    torque = cross(nrm * eff_r[..., None],
                   friction_dir * friction_mag[..., None])
    ang_b = ang_n + torque / inertia[..., None] * dt

    out = outside[..., None]
    pos = torch.where(m & out, pos_b, torch.where(m, pos_n, pos))
    vel = torch.where(m & out, vel_b, torch.where(m, vel_n, vel))
    ang = torch.where(m & out, ang_b, torch.where(m, ang_n, ang))
    return pos, vel, ang


def rotation_core(rot, ang, torque_accum, inertia, mask,
                  params: SimParams, dt):
    """UpdateRotation core: drain the torque accumulator (already ×dt,
    :291), damp ω again, integrate the quaternion by axis-angle
    (:379-408). Unmasked rows keep their inputs. Returns (rot, ang)."""
    ang_n = ang + torque_accum / inertia[..., None]
    ang_n = ang_n * _exp(-params.torque_damping * dt)
    rot_n = quat.integrate_angular(rot, ang_n, dt)
    m = mask[..., None]
    return torch.where(m, rot_n, rot), torch.where(m, ang_n, ang)


def update_motion(state: SimState, params: SimParams, dt=None) -> SimState:
    dt = params.dt if dt is None else dt
    pos, vel, ang = motion_core(
        state.pos, state.vel, state.ang_vel, state.radius, state.inertia,
        state.drag, alive_mask(state), params, dt)
    return state.replace_fields(pos=pos, vel=vel, ang_vel=ang)


def update_rotation(state: SimState, params: SimParams,
                    dt=None) -> SimState:
    """Rotation pass; zeroes the torque accumulator (:379-408)."""
    dt = params.dt if dt is None else dt
    rot, ang = rotation_core(state.rot, state.ang_vel, state.torque_accum,
                             state.inertia, alive_mask(state), params, dt)
    return state.replace_fields(ang_vel=ang, rot=rot,
                                torque_accum=torch.zeros_like(
                                    state.torque_accum))
