"""Adhesion constraints: spring, anchor swing and relative orientation —
the counterpart of sph_tpu.physics.adhesion (ApplyAdhesionConstraints /
ApplyAdhesionDeltas, SimulateParticles.compute:424-607).

Per-bond deltas come from one snapshot and are summed per particle in a
FIXED order, with no atomics, so the sum is the same on every run
(DESIGN.md §1, §8). Two accumulates, as in the JAX package:

- the plain one (`accumulate_bond_deltas`): a stable sort of the 2B
  endpoint rows by particle, then a sequential left-to-right sum within
  each particle's run — the order the JAX package's segment_sum adds them
  in on the CPU;
- the planned one (`BondPlan`, `accumulate_bond_deltas_planned` and
  `_hybrid`): the sort is frozen per bond topology, and each step is one
  row gather, a segmented Hillis-Steele scan of pads, adds and selects in
  JAX's tree, and one gather of each particle's run total. It differs from
  the plain sum only by reassociation, and equals JAX's planned sum bit
  for bit. Bonds that changed since the plan's snapshot ride a small side
  table (the hybrid), so a stale plan is valid on every step.

Both read one [Mp, 7] row table of the per-bond deltas, `bond_rows`: row i
< B is bond i's [Δv_A | Δq_A], row B + i its [Δv_B | Δq_B], and the rows up
to Mp (2B padded to a multiple of _SEG_W) are zero. On the card it is
kernel A1 (ops/adhesion.py, csrc/adhesion.cu), bitwise to the plain
version here; the planned accumulate of the hybrid's quiet and hybrid
branches is kernel A2 there (`bond_scan`), bitwise to
`accumulate_bond_deltas_planned`, which the CPU runs.

Replicated quirks (DESIGN.md §4): spring parameters come from genome mode
`uid_A % n_modes` (CellAdhesionManager.cs:537); anchor stiffness =
orientation_constraint_strength × 10 (CAM:559); the orientation constraint
is gated on the anchor constraint's enable flag (compute:457-583).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.quat import cross, dot, norm
from sph_tpu_torch.core.types import (
    GenomeDevice,
    SimParams,
    SimState,
    state_dataclass,
)
from sph_tpu_torch.physics.contact import alive_mask
from sph_tpu_torch.utils.profiling import span


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


def padded_rows(n_bonds: int) -> int:
    """Mp: the 2B endpoint rows padded to a multiple of _SEG_W."""
    return -(-2 * n_bonds // _SEG_W) * _SEG_W


def bond_rows(state: SimState, params: SimParams, genome: GenomeDevice,
              dt=None) -> torch.Tensor:
    """The [Mp, 7] endpoint row table: each bond's endpoint rows gathered
    from the cells at its slots (clamped to the cells), its spring
    parameters, and bond_pair_deltas' rows [Δv_A | Δq_A] (rows 0..B−1),
    [Δv_B | Δq_B] (rows B..2B−1), zero pad rows. The plain version of
    kernel A1 (ops/adhesion.py `bond_rows`)."""
    b = state.bonds
    N = state.capacity
    dt = params.dt if dt is None else dt
    idx_a = torch.clamp(b.slot_a, 0, N - 1).long()
    idx_b = torch.clamp(b.slot_b, 0, N - 1).long()
    tbl = torch.cat([state.pos, state.vel, state.rot,
                     state.mass[:, None]], dim=1)            # [N, 11]
    ga, gb = tbl[idx_a], tbl[idx_b]
    dv_a, dq_a, dv_b, dq_b = bond_pair_deltas(
        b, _valid(b), *bond_spring_params(b, genome),
        ga[:, 0:3], ga[:, 3:6], ga[:, 6:10], ga[:, 10],
        gb[:, 0:3], gb[:, 3:6], gb[:, 6:10], gb[:, 10], params, dt)
    rows = torch.cat([torch.cat([dv_a, dq_a], dim=1),
                      torch.cat([dv_b, dq_b], dim=1)])        # [2B, 7]
    return F.pad(rows, (0, 0, 0, padded_rows(b.capacity) - rows.shape[0]))


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
    with span("sph.read.segment"):
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


def accumulate_bond_deltas(rows, seg_a, seg_b, n_rows):
    """ONE segmented sum of the first 2B rows of a row table (bond_rows'
    layout, B = len(seg_a)) by particle: row i goes to seg_a[i], row B + i
    to seg_b[i] (ids ≥ n_rows are the drop bucket). Returns (Δv [n, 3],
    Δq [n, 4])."""
    idx_all = torch.cat([seg_a, seg_b])
    acc = segment_sum_sorted(rows[:idx_all.shape[0]], idx_all, n_rows)
    return acc[:, :3], acc[:, 3:]


# -- the planned accumulate -------------------------------------------------
#
# The endpoint rows are permuted into particle order ONCE per bond-table
# change; each step is then one row gather, a segmented scan and one gather
# of the run totals. A plan with stale validity stays correct:
# bond_rows zeroes every component of an invalid bond, so a bond
# pruned after the plan was built adds exact zeros to its stale run. Slot
# rewrites and new bonds (only process_pending_splits makes them) ride the
# hybrid's side table.

_SEG_W = 512

# Capacity of the hybrid's side table: bonds whose endpoints changed since
# the plan's snapshot are summed there with one small segmented sum. A
# division step touches at most max_splits × (a parent's bond count) bonds;
# past this the step takes the plain accumulate of the whole table.
_SIDE_CAP = 2048

# How often each branch of the hybrid accumulate ran, and how often a plan
# was built, on any device: the count a run reads to show which path it
# took (reset_plan_counts sets them to 0).
PLAN_COUNTS = {"quiet": 0, "hybrid": 0, "full": 0, "builds": 0}


def reset_plan_counts() -> None:
    for name in PLAN_COUNTS:
        PLAN_COUNTS[name] = 0


@state_dataclass
class BondPlan:
    """Frozen accumulation order for one bond-table topology.

    perm [Mp] (int64): the endpoint-row order sorted by particle id (Mp =
    2B padded to a multiple of _SEG_W; padding and invalid rows sort into
    the drop run). flags [Mp] bool: run starts in sorted order. last [n]
    (int64) / has [n] bool: per particle, the sorted row holding its run
    total (clipped to [0, Mp); has masks particles with no bonds). The
    JAX package keeps perm and last as int32: the values are the same.

    snap_a / snap_b / snap_active [B]: the bond table the plan was built
    from. A bond whose endpoints and activation still match it accumulates
    through the frozen order; one that changed is zeroed there and summed
    through the hybrid's side table."""

    perm: torch.Tensor
    flags: torch.Tensor
    last: torch.Tensor
    has: torch.Tensor
    snap_a: torch.Tensor
    snap_b: torch.Tensor
    snap_active: torch.Tensor


def _valid(bonds) -> torch.Tensor:
    return bonds.active & (bonds.slot_a >= 0) & (bonds.slot_b >= 0)


def _segments(bonds, n_rows: int):
    """(seg_a, seg_b): each bond's endpoint slots clipped to the rows, and
    n_rows (the drop bucket) for an invalid bond."""
    valid = _valid(bonds)
    drop = torch.full_like(bonds.slot_a, n_rows)
    return (torch.where(valid, torch.clamp(bonds.slot_a, 0, n_rows - 1),
                        drop),
            torch.where(valid, torch.clamp(bonds.slot_b, 0, n_rows - 1),
                        drop))


def build_bond_plan(bonds, n_rows: int) -> BondPlan:
    """A stable sort of the 2B endpoint rows by particle id: a particle's
    A-side rows stay before its B-side rows, each in bond order — the
    relative order segment_sum adds them in."""
    with span("sph.plan.build"):
        return _build_bond_plan(bonds, n_rows)


def _build_bond_plan(bonds, n_rows: int) -> BondPlan:
    PLAN_COUNTS["builds"] += 1
    M = 2 * bonds.capacity
    Mp = padded_rows(bonds.capacity)
    dev = bonds.active.device
    seg_a, seg_b = _segments(bonds, n_rows)
    seg = torch.cat([seg_a, seg_b, torch.full((Mp - M,), n_rows,
                                               dtype=seg_a.dtype,
                                               device=dev)])
    seg_s, perm = torch.sort(seg, stable=True)
    step = seg_s[1:] != seg_s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    flags = torch.cat([one, step])
    is_last = torch.cat([step, one])
    # Only the drop run's rows share a target: n_rows, sliced off.
    tgt = torch.where(is_last & (seg_s < n_rows), seg_s, n_rows).long()
    last = torch.full((n_rows + 1,), -1, dtype=torch.int64, device=dev)
    last[tgt] = torch.arange(Mp, device=dev)
    last = last[:n_rows]
    return BondPlan(perm=perm, flags=flags,
                    last=torch.clamp(last, 0, Mp - 1), has=last >= 0,
                    snap_a=bonds.slot_a, snap_b=bonds.slot_b,
                    snap_active=bonds.active)


def plan_changed(bonds, plan: BondPlan) -> torch.Tensor:
    """Per bond: does this ACTIVE bond differ from the plan's snapshot?
    (A deactivated bond needs nothing: its deltas are exact zeros.)"""
    return bonds.active & ((bonds.slot_a != plan.snap_a)
                           | (bonds.slot_b != plan.snap_b)
                           | ~plan.snap_active)


def plan_changed_count(bonds, plan: BondPlan) -> torch.Tensor:
    """How many active bonds drifted from the plan's snapshot (an int32
    scalar tensor): the rebuild trigger of engine.step.run_steps."""
    return plan_changed(bonds, plan).sum(dtype=torch.int32)


def _blocked_segscan(rs: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Inclusive SEGMENTED prefix sum over [Mp, F] rows with run-start
    flags: a two-level Hillis-Steele of pads, slices, adds and selects in
    the JAX package's order, so its sum tree is JAX's. The identity is
    (flag False, value 0)."""
    M, C = rs.shape
    W = _SEG_W
    Mb = M // W
    v = rs.reshape(Mb, W, C)
    f = flags.reshape(Mb, W)
    d = 1
    while d < W:
        vs = F.pad(v, (0, 0, d, 0))[:, :W]
        fs = F.pad(f, (d, 0), value=False)[:, :W]
        v = torch.where(f[..., None], v, v + vs)
        f = f | fs
        d *= 2
    bt_v, bt_f = v[:, -1], f[:, -1]
    d = 1
    while d < Mb:
        vs = F.pad(bt_v, (0, 0, d, 0))[:Mb]
        fs = F.pad(bt_f, (d, 0), value=False)[:Mb]
        bt_v = torch.where(bt_f[:, None], bt_v, bt_v + vs)
        bt_f = bt_f | fs
        d *= 2
    pre_v = F.pad(bt_v, (0, 0, 1, 0))[:Mb]
    # Rows before their block's first run start continue the open run.
    v = torch.where(f[..., None], v, v + pre_v[:, None, :])
    return v.reshape(M, C)


def accumulate_bond_deltas_planned(rows, plan: BondPlan, zero_bond=None):
    """The planned counterpart of accumulate_bond_deltas: the [Mp, 7] row
    table through the plan's frozen order and the segmented scan. The
    plain version of kernel A2 (ops/adhesion.py `bond_scan`).

    zero_bond [B] (optional): bonds whose two rows are zeroed in the
    frozen stream (they changed since the snapshot and are summed through
    the side table instead)."""
    if zero_bond is not None:
        pad = zero_bond.new_zeros(rows.shape[0] - 2 * zero_bond.shape[0])
        z = torch.cat([zero_bond, zero_bond, pad])
        rows = torch.where(z[:, None], 0.0, rows)
    cs = _blocked_segscan(rows[plan.perm], plan.flags)
    acc = torch.where(plan.has[:, None], cs[plan.last], 0.0)
    return acc[:, :3], acc[:, 3:]


def accumulate_bond_deltas_hybrid(rows, bonds, n_rows: int, plan: BondPlan):
    """The planned accumulate under a plan that may be STALE, in the JAX
    package's three branches, chosen by one host read of the changed
    count:

    - quiet (no bond changed): the planned accumulate alone;
    - hybrid (1 to _SIDE_CAP changed): the changed bonds' rows are zeroed
      in the frozen stream and compacted — a cumsum of the changed flags
      and a searchsorted, no scatter — into a side table of _SIDE_CAP
      bonds summed with the plain accumulate;
    - full (more changed): the plain accumulate of the whole table
      (engine.step.run_steps rebuilds the plan well before that).

    The planned accumulate goes through ops.adhesion.bond_scan: kernel A2
    on the card, accumulate_bond_deltas_planned on the CPU."""
    from sph_tpu_torch.ops.adhesion import bond_scan

    changed = plan_changed(bonds, plan)
    with span("sph.read.changed"):
        n_changed = int(changed.sum())
    if n_changed == 0:
        PLAN_COUNTS["quiet"] += 1
        return bond_scan(rows, plan)
    seg_a, seg_b = _segments(bonds, n_rows)
    if n_changed > _SIDE_CAP:
        PLAN_COUNTS["full"] += 1
        return accumulate_bond_deltas(rows, seg_a, seg_b, n_rows)
    PLAN_COUNTS["hybrid"] += 1
    dvp, dqp = bond_scan(rows, plan, zero_bond=changed)
    dev = changed.device
    r = torch.cumsum(changed.to(torch.int32), 0, dtype=torch.int32)
    sel = torch.searchsorted(
        r, 1 + torch.arange(_SIDE_CAP, dtype=torch.int32, device=dev))
    sel = torch.clamp(sel, 0, changed.shape[0] - 1)
    live = torch.arange(_SIDE_CAP, device=dev) < n_changed
    drop = torch.full_like(seg_a[sel], n_rows)
    # seg_a/seg_b already drop invalid bonds.
    side = rows[torch.cat([sel, sel + changed.shape[0]])]   # [2·cap, 7]
    dv_s, dq_s = accumulate_bond_deltas(
        side, torch.where(live, seg_a[sel], drop),
        torch.where(live, seg_b[sel], drop), n_rows)
    return dvp + dv_s, dqp + dq_s


def bond_deltas(state: SimState, params: SimParams, genome: GenomeDevice,
                dt=None, plan: BondPlan | None = None):
    """Per-bond velocity and rotation deltas summed per particle:
    ([N, 3], [N, 4]). The row table comes from kernel A1 on the card and
    from the plain bond_rows on the CPU. With a `plan` (valid for this
    bond table's capacities, possibly stale) the sum takes the hybrid
    planned accumulate."""
    from sph_tpu_torch.ops.adhesion import bond_rows as rows_of

    with span("sph.adhesion.pairs"):
        rows = rows_of(state, params, genome, dt)
    with span("sph.adhesion.accumulate"):
        if plan is not None:
            return accumulate_bond_deltas_hybrid(rows, state.bonds,
                                                 state.capacity, plan)
        return accumulate_bond_deltas(
            rows, *_segments(state.bonds, state.capacity), state.capacity)


def apply_adhesion(state: SimState, params: SimParams, genome: GenomeDevice,
                   dt=None, plan: BondPlan | None = None) -> SimState:
    """Compute the per-bond deltas and apply them (compute:586-607):
    v += Δv, q = normalize(q + Δq) on live rows."""
    dv, dq = bond_deltas(state, params, genome, dt=dt, plan=plan)
    alive = alive_mask(state)[:, None]
    vel = torch.where(alive, state.vel + dv, state.vel)
    rot = torch.where(alive, quat.normalize(state.rot + dq), state.rot)
    return state.replace_fields(vel=vel, rot=rot)
