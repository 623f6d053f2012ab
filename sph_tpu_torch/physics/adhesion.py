"""Adhesion constraints: spring, anchor swing and relative orientation —
the counterpart of sph_tpu.physics.adhesion (ApplyAdhesionConstraints /
ApplyAdhesionDeltas, SimulateParticles.compute:424-607), plain path only.

Per-bond deltas come from one snapshot and are summed per particle in a
FIXED order: a stable sort of the 2B endpoint rows by particle, then a
sequential left-to-right sum within each particle's run — the order the
JAX package's segment_sum adds them in on the CPU. No atomics, so the sum
is the same on every run (DESIGN.md §1, §8). The JAX package's BondPlan
(its scatter-free TPU accumulate) is not ported; it differs from this sum
only by reassociation.

Replicated quirks (DESIGN.md §4): spring parameters come from genome mode
`uid_A % n_modes` (CellAdhesionManager.cs:537); anchor stiffness =
orientation_constraint_strength × 10 (CAM:559); the orientation constraint
is gated on the anchor constraint's enable flag (compute:457-583).
"""

from __future__ import annotations

import torch

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.quat import cross, dot, norm
from sph_tpu_torch.core.types import GenomeDevice, SimParams, SimState
from sph_tpu_torch.physics.contact import alive_mask


def _axis_angle_delta(axis, angle, q):
    """quat_mul(axis_angle(axis, angle), q) − q (compute:505-506)."""
    rq = quat.from_axis_angle(axis, angle)
    return quat.mul(rq, q) - q


def bond_spring_params(bonds, genome: GenomeDevice):
    """Per-bond spring parameters from mode uid_A % n_modes (CAM:537) —
    the reference quirk, NOT the cell's own mode. Returns (rest, stiff,
    damp, anchor_stiff), each [B]."""
    n_modes = torch.clamp(genome.n_modes, min=1)
    mode = torch.remainder(bonds.uid_a, n_modes)
    mode = torch.minimum(torch.clamp(mode, min=0), n_modes - 1).long()
    rest = genome.adhesion_rest_length[mode]
    stiff = genome.adhesion_spring_stiffness[mode]
    damp = genome.adhesion_spring_damping[mode]
    anchor_stiff = genome.orientation_constraint_strength[mode] * 10.0
    return rest, stiff, damp, anchor_stiff


def bond_pair_deltas(b, valid, rest, stiff, damp, anchor_stiff,
                     pos_a, vel_a, q_a, m_a, pos_b, vel_b, q_b, m_b,
                     params: SimParams, dt):
    """Per-bond constraint math (compute:436-583) on gathered endpoint
    rows. Returns (dv_a, dq_a, dv_b, dq_b), zero where not valid."""
    # Spring (distance) constraint (compute:436-456).
    delta = pos_b - pos_a
    dist = norm(delta)
    spring_ok = valid & (dist > 1e-6)
    dirv = delta / torch.clamp(dist, min=1e-20)[:, None]
    force = dirv * ((dist - rest) * stiff)[:, None]
    rel_vel = vel_b - vel_a
    force = force + dirv * (dot(rel_vel, dirv) * damp)[:, None]
    dv_a = torch.where(spring_ok[:, None], force / m_a[:, None] * dt, 0.0)
    dv_b = torch.where(spring_ok[:, None], -force / m_b[:, None] * dt, 0.0)

    # Anchor and orientation constraints (compute:457-583).
    enabled = valid & bool(params.enable_anchor_constraints)
    strength = anchor_stiff * dt  # compute:460

    anchor_world_a = pos_a + quat.rotate(q_a, b.anchor_a)
    anchor_world_b = pos_b + quat.rotate(q_b, b.anchor_b)
    a_delta = anchor_world_b - anchor_world_a
    a_dist = norm(a_delta)
    anchor_ok = enabled & (a_dist > 1e-6)
    a_dir = a_delta / torch.clamp(a_dist, min=1e-20)[:, None]

    def swing(qx, anchor_local, desired):
        """Rotation delta swinging the body-frame anchor toward `desired`
        (compute:474-539)."""
        r_world = quat.rotate(qx, anchor_local)
        axis = cross(r_world, desired)
        axis_len = norm(axis)
        axis_n = axis / torch.clamp(axis_len, min=1e-20)[:, None]
        effectiveness = torch.abs(dot(cross(axis_n, r_world), desired))
        ok = anchor_ok & (axis_len > 1e-6) & (effectiveness > 1e-6)
        angle = strength * effectiveness * 5.0  # compute:504
        dq = _axis_angle_delta(axis_n, angle, qx)
        return torch.where(ok[:, None], dq, 0.0)

    dq_a = swing(q_a, b.anchor_a, a_dir)
    dq_b = swing(q_b, b.anchor_b, -a_dir)

    # Relative-orientation constraint (compute:541-583).
    cur_rel = quat.mul(quat.conjugate(q_a), q_b)
    corr = quat.mul(b.rel_orientation, quat.conjugate(cur_rel))
    corr_v = corr[:, :3]
    corr_angle = 2.0 * torch.atan2(norm(corr_v), torch.abs(corr[:, 3]))
    orient_ok = enabled & (corr_angle > 1e-6)
    corr_axis = corr_v / torch.clamp(norm(corr_v), min=1e-20)[:, None]
    o_strength = strength * 2.0  # compute:557
    angle_a = -o_strength * corr_angle * 0.5
    angle_b = o_strength * corr_angle * 0.5
    dq_a = dq_a + torch.where(
        orient_ok[:, None], _axis_angle_delta(corr_axis, angle_a, q_a), 0.0)
    dq_b = dq_b + torch.where(
        orient_ok[:, None], _axis_angle_delta(corr_axis, angle_b, q_b), 0.0)
    return dv_a, dq_a, dv_b, dq_b


def segment_sum_sorted(rows: torch.Tensor, seg: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Σ rows per segment id in [0, n_rows) (ids ≥ n_rows are dropped), in
    a fixed order: a stable sort by id keeps each segment's rows in their
    input order, they are laid out as [n_rows, R] by rank within the
    segment (R = the longest segment, one host read), and the sum runs
    left to right from +0 — segment_sum's sequential order."""
    M, F = rows.shape
    dev = rows.device
    seg_s, order = torch.sort(seg.long(), stable=True)
    live = seg_s < n_rows
    i = torch.arange(M, device=dev)
    is_start = torch.ones(M, dtype=torch.bool, device=dev)
    is_start[1:] = seg_s[1:] != seg_s[:-1]
    start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    rank = i - start
    R = int(torch.where(live, rank + 1, 0).max()) if M else 0
    out = torch.zeros((n_rows, F), dtype=rows.dtype, device=dev)
    if R == 0:
        return out
    # Every live (segment, rank) pair is unique; dropped rows land in the
    # extra row n_rows, which is sliced off.
    flat = torch.where(live, seg_s * R + rank, n_rows * R)
    table = torch.zeros(((n_rows + 1) * R, F), dtype=rows.dtype, device=dev)
    table[flat] = rows[order]
    table = table[: n_rows * R].view(n_rows, R, F)
    for r in range(R):
        out = out + table[:, r]
    return out


def accumulate_bond_deltas(dv_a, dq_a, dv_b, dq_b, seg_a, seg_b, n_rows):
    """ONE segmented sum of the [Δv|Δq] rows of both endpoints by particle
    (ids ≥ n_rows are the drop bucket). Returns (Δv [n, 3], Δq [n, 4])."""
    idx_all = torch.cat([seg_a, seg_b])
    rows = torch.cat([torch.cat([dv_a, dq_a], dim=1),
                      torch.cat([dv_b, dq_b], dim=1)])        # [2B, 7]
    acc = segment_sum_sorted(rows, idx_all, n_rows)
    return acc[:, :3], acc[:, 3:]


def bond_inputs(state: SimState, params: SimParams, genome: GenomeDevice,
                dt=None):
    """(bond_pair_deltas' arguments, (seg_a, seg_b)): the per-bond spring
    parameters and ONE wide-row gather per endpoint; the segment ids are
    the endpoint slots, N (the drop bucket) for invalid bonds."""
    b = state.bonds
    N = state.capacity
    dt = params.dt if dt is None else dt
    idx_a = torch.clamp(b.slot_a, 0, N - 1).long()
    idx_b = torch.clamp(b.slot_b, 0, N - 1).long()
    valid = b.active & (b.slot_a >= 0) & (b.slot_b >= 0)
    tbl = torch.cat([state.pos, state.vel, state.rot,
                     state.mass[:, None]], dim=1)            # [N, 11]
    ga, gb = tbl[idx_a], tbl[idx_b]
    args = (b, valid, *bond_spring_params(b, genome),
            ga[:, 0:3], ga[:, 3:6], ga[:, 6:10], ga[:, 10],
            gb[:, 0:3], gb[:, 3:6], gb[:, 6:10], gb[:, 10], params, dt)
    drop = torch.full_like(idx_a, N)
    return args, (torch.where(valid, idx_a, drop),
                  torch.where(valid, idx_b, drop))


def bond_deltas(state: SimState, params: SimParams, genome: GenomeDevice,
                dt=None):
    """Per-bond velocity and rotation deltas summed per particle:
    ([N, 3], [N, 4])."""
    args, (seg_a, seg_b) = bond_inputs(state, params, genome, dt)
    return accumulate_bond_deltas(*bond_pair_deltas(*args), seg_a, seg_b,
                                  state.capacity)


def apply_adhesion(state: SimState, params: SimParams, genome: GenomeDevice,
                   dt=None) -> SimState:
    """Compute the per-bond deltas and apply them (compute:586-607):
    v += Δv, q = normalize(q + Δq) on live rows."""
    dv, dq = bond_deltas(state, params, genome, dt=dt)
    alive = alive_mask(state)[:, None]
    vel = torch.where(alive, state.vel + dv, state.vel)
    rot = torch.where(alive, quat.normalize(state.rot + dq), state.rot)
    return state.replace_fields(vel=vel, rot=rot)
