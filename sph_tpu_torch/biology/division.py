"""Genome-driven cell division — the counterpart of
sph_tpu.biology.division (UpdateCellDivisionTimers / SplitCell /
ProcessPendingSplits, ParticleSystemController.cs:631-969; DESIGN.md §5):

- splits detected in step t are queued and applied at the start of step
  t+1 (the reference's one-frame deferral, cs:643-646);
- timers reset for ALL ready cells even when queueing is capped (cs:682);
- child A overwrites the parent slot, child B appends; uids are allocated
  A then B in queue order (cs:846-851).

The JAX package's `lax.cond` gates become host reads of their predicates,
and its `lax.scan` over the pending queue a host loop over the pending
count.
"""

from __future__ import annotations

import torch

from sph_tpu_torch.biology.bonds import handle_cell_split
from sph_tpu_torch.core import quat
from sph_tpu_torch.core.types import (
    GenomeDevice,
    PendingSplits,
    SimParams,
    SimState,
)
from sph_tpu_torch.physics.contact import alive_mask
from sph_tpu_torch.utils.profiling import span


def division_ready(state: SimState, params: SimParams, genome: GenomeDevice,
                   dt=None):
    """Timer advance and readiness test (cs:648-659, with its 0.001
    epsilon). Returns (timer_advanced, ready_mask, mode_clipped)."""
    N = state.capacity
    alive = alive_mask(state)
    dt = params.dt if dt is None else dt
    n_modes = genome.n_modes
    # The reference returns before advancing timers when there is no
    # capacity headroom or no genome mode (cs:648-649): timers freeze.
    gate = (state.active_count < N) & (n_modes > 0)
    timer = torch.where(gate & alive, state.split_timer + dt,
                        state.split_timer)
    mode_valid = alive & (state.mode >= 0) & (state.mode < n_modes)
    mode_c = torch.minimum(torch.clamp(state.mode, min=0),
                           torch.clamp(n_modes - 1, min=0))
    interval = genome.split_interval[mode_c.long()]
    ready = gate & mode_valid & (timer >= interval - 0.001)  # cs:659
    return timer, ready, mode_c


def queue_splits(state: SimState, params: SimParams, genome: GenomeDevice,
                 dt=None) -> SimState:
    """Advance timers, detect ready cells (slot order, capped by capacity
    headroom and max_splits_per_step) and queue their split data from the
    CURRENT pose (cs:652-778). One host read: is any cell ready?"""
    N = state.capacity
    S = state.pending.parent_slot.shape[0]
    timer, ready, mode_c = division_ready(state, params, genome, dt=dt)
    allowed = torch.clamp(N - state.active_count, min=0)  # cs:648
    allowed = torch.clamp(allowed, max=S)
    rank = torch.cumsum(ready.to(torch.int32), 0) - 1
    queued = ready & (rank < allowed)
    # Timers reset for every ready cell, queued or not (cs:682).
    timer = torch.where(ready, 0.0, timer)
    with span("sph.read.ready"):
        any_ready = bool(ready.any())
    if any_ready:
        pending = _build_pending(state, params, genome, queued, rank,
                                 mode_c, S)
    else:
        pending = PendingSplits.empty(S, state.device)
    return state.replace_fields(split_timer=timer, pending=pending)


def _build_pending(state, params, genome, queued, rank, mode_c, S):
    """Split geometry and dense packing of the queued cells (SplitCell,
    cs:729-778)."""
    N = state.capacity
    dev = state.device
    slots = torch.arange(N, dtype=torch.int32, device=dev)
    n_modes = genome.n_modes
    mode_row = mode_c.long()

    def child_mode(child_idx):
        # -1 or out of range ⇒ inherit the parent's mode (cs:742-747).
        ci = child_idx[mode_row]
        return torch.where((ci >= 0) & (ci < n_modes), ci, mode_c)

    mode_a = child_mode(genome.child_a_mode_index)
    mode_b = child_mode(genome.child_b_mode_index)
    right, up, fwd = quat.axis3(state.rot)

    def local_to_world(d_local):
        return (right * d_local[..., 0:1] + up * d_local[..., 1:2]
                + fwd * d_local[..., 2:3])

    split_dir = local_to_world(quat.euler_direction(
        genome.parent_split_yaw[mode_row],
        genome.parent_split_pitch[mode_row]))
    pos_a = state.pos + split_dir * params.spawn_overlap_offset
    pos_b = state.pos - split_dir * params.spawn_overlap_offset
    # The parent's velocity is ignored (cs:761).
    vel_a = split_dir * params.split_velocity_magnitude
    vel_b = -split_dir * params.split_velocity_magnitude
    dir_a = local_to_world(quat.euler_direction(
        genome.child_a_orientation_yaw[mode_row],
        genome.child_a_orientation_pitch[mode_row]))
    dir_b = local_to_world(quat.euler_direction(
        genome.child_b_orientation_yaw[mode_row],
        genome.child_b_orientation_pitch[mode_row]))
    rot_a = quat.look_rotation(dir_a, up)
    rot_b = quat.look_rotation(dir_b, up)

    # Queued splits packed densely by rank; row S is the trash row (queued
    # ranks are unique, so no two kept writes collide).
    target = torch.where(queued, torch.clamp(rank, 0, S - 1), S).long()

    def pack(per_particle, init):
        padded = torch.cat([init, init[:1]], dim=0)
        padded[target] = per_particle.to(init.dtype)
        return padded[:S]

    p0 = PendingSplits.empty(S, dev)
    return PendingSplits(
        count=torch.sum(queued).to(torch.int32),
        parent_slot=pack(slots, p0.parent_slot),
        pos_a=pack(pos_a, p0.pos_a), pos_b=pack(pos_b, p0.pos_b),
        vel_a=pack(vel_a, p0.vel_a), vel_b=pack(vel_b, p0.vel_b),
        rot_a=pack(rot_a, p0.rot_a), rot_b=pack(rot_b, p0.rot_b),
        mode_a=pack(mode_a, p0.mode_a), mode_b=pack(mode_b, p0.mode_b),
        parent_mode=pack(mode_c, p0.parent_mode),
    )


def process_pending_splits(state: SimState, params: SimParams,
                           genome: GenomeDevice) -> SimState:
    """Apply last step's queued splits in queue order (ProcessPendingSplits,
    cs:780-964), with bond inheritance per split (CAM:425-509). Sequential
    because splits of one step can chain through the bond table. A quiet
    step makes one host read (the pending count); a division step reads
    the counters and the queue once more."""
    S = state.pending.parent_slot.shape[0]
    N = state.capacity
    with span("sph.read.pending"):
        count = int(state.pending.count)
    if count > 0:
        state = _apply_splits(state, genome, count, N)
    return state.replace_fields(pending=PendingSplits.empty(S, state.device))


def _apply_splits(state: SimState, genome: GenomeDevice, count: int, N: int):
    pend = state.pending
    with span("sph.read.splits"):
        active, next_uid, step = (int(v) for v in torch.stack(
            [state.active_count, state.next_uid, state.step_count]).tolist())
        parent_slots = pend.parent_slot.tolist()
        mode_a_host = pend.mode_a.tolist()
        keep_a_tbl = genome.child_a_keep_adhesion.tolist()
        keep_b_tbl = genome.child_b_keep_adhesion.tolist()
        make_tbl = genome.parent_make_adhesion.tolist()
    n_modes = max(genome.n_modes_host - 1, 0)
    st = state
    overflow = st.overflow
    for k in range(count):
        if active >= N:       # `do` is false for this and every later split
            break
        parent_slot = min(max(parent_slots[k], 0), N - 1)
        slot_b = min(max(active, 0), N - 1)
        parent_uid = st.uid[parent_slot]
        uid_a, uid_b = next_uid, next_uid + 1

        def w2(arr, va, vb):
            arr = arr.clone()
            arr[parent_slot] = va
            arr[slot_b] = vb
            return arr

        def copy_b(arr):
            arr = arr.clone()
            arr[slot_b] = arr[parent_slot].clone()
            return arr

        # Child A overwrites the parent slot; child B copies its struct
        # (radius/mass/inertia/drag/repulsion inherited, cs:854-869).
        pos = w2(st.pos, pend.pos_a[k], pend.pos_b[k])
        vel = w2(st.vel, pend.vel_a[k], pend.vel_b[k])
        rot = w2(st.rot, pend.rot_a[k], pend.rot_b[k])
        mode = w2(st.mode, pend.mode_a[k], pend.mode_b[k])
        timer = w2(st.split_timer, 0.0, 0.0)
        uid = w2(st.uid, uid_a, uid_b)
        p_uid = w2(st.parent_uid, parent_uid, parent_uid)
        ctype = w2(st.child_type, 0, 1)

        # Adhesion flags come from CHILD A's resolved mode (cs:857 write,
        # cs:933 read).
        fm = min(max(mode_a_host[k], 0), n_modes)
        bonds, dropped = handle_cell_split(
            st.bonds, rot, parent_uid, uid_a, uid_b, parent_slot, slot_b,
            keep_a_tbl[fm], keep_b_tbl[fm], make_tbl[fm], step)
        overflow = overflow + dropped
        active += 1
        next_uid += 2
        st = st.replace_fields(
            pos=pos, vel=vel, rot=rot, mode=mode,
            ang_vel=copy_b(st.ang_vel), radius=copy_b(st.radius),
            mass=copy_b(st.mass), inertia=copy_b(st.inertia),
            drag=copy_b(st.drag), repulsion=copy_b(st.repulsion),
            split_timer=timer, uid=uid, parent_uid=p_uid, child_type=ctype,
            bonds=bonds)
    dev = state.device
    return st.replace_fields(
        active_count=torch.tensor(active, dtype=torch.int32, device=dev),
        next_uid=torch.tensor(next_uid, dtype=torch.int32, device=dev),
        overflow=overflow.to(torch.int32))
