"""Soft-sphere contact forces and rolling-friction torque — the counterpart
of sph_tpu.physics.contact (re-specification of ApplySPHForces,
SimulateParticles.compute:211-309; DESIGN.md §2). All pair math reads the
pre-pass snapshot; the partner-torque atomic scatter is the algebraically
identical self-torque sum, accumulated into `torque_accum`.
"""

from __future__ import annotations

import torch

from sph_tpu_torch.core.quat import cross, dot, norm
from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.utils.profiling import span


def pair_contact(pos_i, vel_i, omega_i, r_i, pos_j, vel_j, omega_j, r_j,
                 valid, params: SimParams):
    """Per-pair repulsion force and rolling torque on particle i,
    broadcasting over leading axes; zero where `valid` is False or the pair
    is not in contact. Returns (force_i, torque_i)."""
    eff_i = r_i * 0.5  # contact radius is half the visual one (:225)
    eff_j = r_j * 0.5
    delta = pos_i - pos_j
    dist = norm(delta)
    safe_dist = torch.clamp(dist, min=1e-12)
    overlap = (eff_i + eff_j) - dist
    in_contact = valid & (overlap > params.contact_epsilon)  # :253

    dirv = delta / safe_dist[..., None]
    sum_r = eff_i + eff_j
    overlap_falloff = torch.clamp(overlap / sum_r, 0.0, 1.0)
    falloff = torch.clamp(1.0 - dist / sum_r, 0.0, 1.0)
    repulsion = dirv * (
        falloff * params.repulsion_strength * overlap_falloff)[..., None]

    # Rolling contact friction (:263-289).
    contact_arm_i = -dirv * eff_i[..., None]
    contact_arm_j = dirv * eff_j[..., None]
    surf_vel_i = vel_i + cross(omega_i, contact_arm_i)
    surf_vel_j = vel_j + cross(omega_j, contact_arm_j)
    rel_surf = surf_vel_i - surf_vel_j
    tangent = rel_surf - dirv * dot(rel_surf, dirv, keepdim=True)
    slip = norm(tangent)
    slipping = in_contact & (slip > params.slip_epsilon)
    friction_dir = tangent / torch.clamp(slip, min=1e-20)[..., None]

    torque_input = torch.abs(slip * params.torque_factor)
    # x^1.25 as x·sqrt(sqrt(x)), the form contact_dense uses too.
    friction_mag = torch.clamp(
        torque_input * torch.sqrt(torch.sqrt(torque_input)), max=10.0)

    torque_r_scale = overlap_falloff ** 2
    eff_torque_i = (torque_r_scale * eff_i
                    * params.rolling_contact_radius_multiplier)
    # cross(−dir·r, −f̂·m) == cross(dir·r, f̂·m) (:286).
    torque_i = cross(dirv * eff_torque_i[..., None],
                     friction_dir * friction_mag[..., None])

    force = torch.where(in_contact[..., None], repulsion, 0.0)
    torque = torch.where(slipping[..., None], torque_i, 0.0)
    return force, torque


def contact_forces_bruteforce(state: SimState, params: SimParams,
                              row_block: int = 512):
    """O(n²) all-pairs contact sums over the live prefix (n =
    active_count, one host read), in row blocks to bound memory — the
    executable-spec path. Dead rows get zero force and torque, which is
    what the JAX version's masked full-capacity sum gives them."""
    N = state.capacity
    with span("sph.read.active"):
        n = int(state.active_count)
    dev = state.device
    force = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    torque = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    cols = torch.arange(n, device=dev)
    pos, vel, om, rad = (state.pos[:n], state.vel[:n], state.ang_vel[:n],
                         state.radius[:n])
    for i0 in range(0, n, row_block):
        i1 = min(n, i0 + row_block)
        valid = cols[i0:i1, None] != cols[None, :]
        f, t = pair_contact(
            pos[i0:i1, None], vel[i0:i1, None], om[i0:i1, None],
            rad[i0:i1, None], pos[None], vel[None], om[None], rad[None],
            valid, params)
        force[i0:i1] = f.sum(dim=1)
        torque[i0:i1] = t.sum(dim=1)
    return force, torque


def alive_mask(state: SimState) -> torch.Tensor:
    """[N] bool: slot < active_count (no host read)."""
    return (torch.arange(state.capacity, device=state.device)
            < state.active_count)


def apply_contact(state: SimState, params: SimParams, force, torque,
                  dt=None) -> SimState:
    """Integrate the contact results (:302-306) and fill the torque
    accumulator with the partner-scatter-equivalent T·dt (DESIGN.md §2)."""
    alive = alive_mask(state)[:, None]
    dt = params.dt if dt is None else dt
    vel = state.vel + torch.where(alive, force / state.mass[:, None] * dt,
                                  0.0)
    ang = state.ang_vel + torch.where(
        alive, torque / state.inertia[:, None] * dt, 0.0)
    accum = torch.where(alive, torque * dt, 0.0)
    return state.replace_fields(vel=vel, ang_vel=ang, torque_accum=accum)
