"""Adhesion bond graph: zone classification, anchors, inheritance and
pruning — the counterpart of sph_tpu.biology.bonds (a fixed-capacity
masked edge table re-implementing CellAdhesionManager.cs). Zones: 0 = A,
1 = B, 2 = C.

Where the JAX package gates a pass with `lax.cond`, this port reads the
predicate on the host and skips the pass the same way; each such read is a
synchronisation point (counted in PERF.md). Every scatter with a possibly
repeated index writes the losers into an extra row that is sliced off, so
no two kept writes ever share an index and the result is deterministic.
"""

from __future__ import annotations

import torch

from sph_tpu_torch.core import quat
from sph_tpu_torch.core.quat import norm
from sph_tpu_torch.core.types import BondTable, GenomeDevice, SimParams, SimState
from sph_tpu_torch.utils.profiling import span

ZONE_A = 0
ZONE_B = 1
ZONE_C = 2


def classify_zone(cell_pos, cell_rot, other_pos, split_yaw, split_pitch,
                  inheritance_angle_deg: float = 10.0):
    """ClassifyBondDirection (CAM:320-336): the angle between the bond
    direction in the cell's frame and the mode's split direction; within
    ±inheritance_angle of 90° ⇒ C, dot > 0 ⇒ B, else A."""
    bond_dir = other_pos - cell_pos
    bond_dir = bond_dir / torch.clamp(norm(bond_dir, keepdim=True), min=1e-12)
    bond_local = quat.rotate(quat.conjugate(cell_rot), bond_dir)
    split_local = quat.euler_direction(split_yaw, split_pitch)
    dot = torch.clamp(torch.sum(bond_local * split_local, dim=-1), -1.0, 1.0)
    angle_deg = torch.rad2deg(torch.arccos(dot))
    zone = torch.where(dot > 0, ZONE_B, ZONE_A).to(torch.int32)
    return torch.where(torch.abs(angle_deg - 90.0) <= inheritance_angle_deg,
                       ZONE_C, zone).to(torch.int32)


def update_bond_zones(state: SimState, params: SimParams,
                      genome: GenomeDevice) -> BondTable:
    """UpdateBondZones (CAM:338-423): bonds are (re)classified only within
    one step of creation; anchors are set one step after creation as the
    surface point along the bond (radius 1.0), in the body frame
    (CAM:377-402). One host read: are there young bonds at all?"""
    b = state.bonds
    young = b.active & (state.step_count <= b.created_step + 1)
    with span("sph.read.young"):
        any_young = bool(young.any())
    if not any_young:
        return b
    return _update_young_bond_zones(state, params, genome, young)


def _update_young_bond_zones(state, params, genome, young) -> BondTable:
    b = state.bonds
    N = state.capacity
    idx_a = torch.clamp(b.slot_a, 0, N - 1).long()
    idx_b = torch.clamp(b.slot_b, 0, N - 1).long()
    pos_a, rot_a = state.pos[idx_a], state.rot[idx_a]
    pos_b, rot_b = state.pos[idx_b], state.rot[idx_b]

    set_anchors = (young & (state.step_count == b.created_step + 1)
                   & ~b.anchors_set)
    bond_dir = pos_b - pos_a
    bond_dir = bond_dir / torch.clamp(norm(bond_dir, keepdim=True), min=1e-12)
    anchor_a_new = quat.rotate(quat.conjugate(rot_a), bond_dir)
    anchor_b_new = quat.rotate(quat.conjugate(rot_b), -bond_dir)
    anchor_a = torch.where(set_anchors[:, None], anchor_a_new, b.anchor_a)
    anchor_b = torch.where(set_anchors[:, None], anchor_b_new, b.anchor_b)
    anchors_set = b.anchors_set | set_anchors

    n_modes = torch.clamp(genome.n_modes, min=1)
    mode_a = torch.minimum(torch.clamp(state.mode[idx_a], min=0),
                           n_modes - 1).long()
    mode_b = torch.minimum(torch.clamp(state.mode[idx_b], min=0),
                           n_modes - 1).long()
    zone_a_new = classify_zone(
        pos_a, rot_a, pos_b, genome.parent_split_yaw[mode_a],
        genome.parent_split_pitch[mode_a], params.inheritance_angle_deg)
    zone_b_new = classify_zone(
        pos_b, rot_b, pos_a, genome.parent_split_yaw[mode_b],
        genome.parent_split_pitch[mode_b], params.inheritance_angle_deg)
    zone_a = torch.where(young, zone_a_new, b.zone_a)
    zone_b = torch.where(young, zone_b_new, b.zone_b)
    return b.replace_fields(anchor_a=anchor_a, anchor_b=anchor_b,
                            anchors_set=anchors_set, zone_a=zone_a,
                            zone_b=zone_b)


def filter_bonds(state: SimState) -> BondTable:
    """FilterBonds (CAM:184-243): eligible bonds are grouped per side —
    (cellA, zoneA) over A-ends and, independently, (cellB, zoneB) over
    B-ends — and in each group all but the shortest are removed (union of
    the two verdicts); groups holding a C↔(A|B) bond are exempt; bonds made
    this step are exempt; ties keep the lowest bond index (DESIGN.md §7.4).

    The pass is a fixed point two steps after the last bond creation or
    rewrite (sph_tpu.biology.bonds.filter_bonds), so it runs only when a
    bond was stamped in the last two steps: one host read."""
    b = state.bonds
    dirty = torch.any(b.created_step >= state.step_count - 2)
    with span("sph.read.dirty"):
        dirty = bool(dirty)
    if not dirty:
        return b
    return _filter_bonds_active(state)


def _segment_min(values, keys, n_keys, fill):
    """Per-key minimum (segment_min): empty keys hold `fill`, the identity
    of JAX's segment_min for that dtype."""
    out = torch.full((n_keys,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, keys, values, "amin", include_self=False)


def _filter_bonds_active(state: SimState) -> BondTable:
    b = state.bonds
    N = state.capacity
    B = b.capacity
    dev = state.device
    idx_a = torch.clamp(b.slot_a, 0, N - 1).long()
    idx_b = torch.clamp(b.slot_b, 0, N - 1).long()
    eligible = b.active & (b.created_step < state.step_count)
    dist = norm(state.pos[idx_b] - state.pos[idx_a])
    mixed = (((b.zone_a == ZONE_C) & (b.zone_b != ZONE_C))
             | ((b.zone_a != ZONE_C) & (b.zone_b == ZONE_C)))

    ns = N * 3
    n_keys = 2 * ns + 1
    last = torch.full_like(idx_a, n_keys - 1)
    key_a = torch.where(eligible, idx_a * 3 + b.zone_a, last)
    key_b = torch.where(eligible, ns + idx_b * 3 + b.zone_b, last)
    keys = torch.cat([key_a, key_b])                      # [2B]
    elig2 = torch.cat([eligible, eligible])
    mixed2 = torch.cat([mixed, mixed])
    d2 = torch.where(elig2, torch.cat([dist, dist]), torch.inf)
    idx2 = torch.cat([torch.arange(B, device=dev)] * 2)

    min_dist = _segment_min(d2, keys, n_keys, torch.inf)
    no_mixed = _segment_min(
        torch.where(elig2 & mixed2, 0.0, 1.0), keys, n_keys, torch.inf)
    min_d_k, no_mixed_k = min_dist[keys], no_mixed[keys]
    is_min = elig2 & (d2 <= min_d_k)
    min_idx = _segment_min(torch.where(is_min, idx2, B), keys, n_keys,
                           torch.iinfo(torch.int64).max)
    rm2 = elig2 & (no_mixed_k > 0.5) & (idx2 != min_idx[keys])
    rm = rm2[:B] | rm2[B:]
    return b.replace_fields(active=b.active & ~rm)


def _padded_set(arr, target, values):
    """arr with values[i] written at target[i]; index len(arr) is a trash
    row (sliced off), so writes aimed there never reach the result."""
    padded = torch.cat([arr, arr[:1]], dim=0)
    padded[target] = values
    return padded[:-1]


def handle_cell_split(bonds: BondTable, rot, parent_uid, uid_a, uid_b,
                      slot_a, slot_b, keep_a: bool, keep_b: bool,
                      make_adhesion: bool, step_count):
    """Bond inheritance for ONE split (HandleCellSplit, CAM:425-509).

    Every bond touching the parent is rewritten in place to its inheriting
    child (or deactivated); the ZoneC-both-children case duplicates it into
    a free slot; `make_adhesion` adds a child-A↔child-B bond. Replicated
    quirk: the ZoneC branch passes `parentBond.zoneA` as the child's zone
    whichever end the parent held (CAM:477-488).

    Ids and slots are Python ints or 0-dim int32 tensors; the keep flags
    are host bools. Returns (bonds, n_dropped) with n_dropped the inserts
    lost to capacity (an int32 tensor)."""
    B = bonds.capacity
    N = rot.shape[0]
    dev = rot.device
    i32 = dict(dtype=torch.int32, device=dev)

    a_is_parent = bonds.uid_a == parent_uid
    touches = bonds.active & (a_is_parent | (bonds.uid_b == parent_uid))
    neighbor_uid = torch.where(a_is_parent, bonds.uid_b, bonds.uid_a)
    neighbor_slot = torch.where(a_is_parent, bonds.slot_b, bonds.slot_a)
    neighbor_zone = torch.where(a_is_parent, bonds.zone_b, bonds.zone_a)
    parent_zone = torch.where(a_is_parent, bonds.zone_a, bonds.zone_b)
    # Zone the child end receives (CAM:477, :494, :500).
    pass_zone = torch.where(parent_zone == ZONE_C, bonds.zone_a, parent_zone)

    # Which child inherits in place: C → A if keep_a else B if keep_b;
    # B → A if keep_a; A → B if keep_b. 0 = none, 1 = A, 2 = B.
    c_choice = 1 if keep_a else (2 if keep_b else 0)
    inherit = torch.where(
        parent_zone == ZONE_C, c_choice,
        torch.where(parent_zone == ZONE_B, 1 if keep_a else 0,
                    2 if keep_b else 0))
    inherit = torch.where(touches, inherit, 0)
    rewrite = inherit > 0
    uid_a_t = torch.as_tensor(uid_a, **i32)
    uid_b_t = torch.as_tensor(uid_b, **i32)
    slot_a_t = torch.as_tensor(slot_a, **i32)
    slot_b_t = torch.as_tensor(slot_b, **i32)
    step_t = torch.as_tensor(step_count, **i32)
    child_uid = torch.where(inherit == 1, uid_a_t, uid_b_t)
    child_slot = torch.where(inherit == 1, slot_a_t, slot_b_t)

    q_child = rot[torch.clamp(child_slot, 0, N - 1).long()]
    nb_row = torch.clamp(neighbor_slot, 0, N - 1).long()
    q_neighbor = rot[nb_row]
    rel = quat.mul(quat.conjugate(q_child), q_neighbor)

    def w(old, new, mask):
        m = mask if old.ndim == 1 else mask[:, None]
        return torch.where(m, new, old)

    zeros3 = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    b = bonds.replace_fields(
        active=w(bonds.active, rewrite, touches),
        uid_a=w(bonds.uid_a, child_uid, rewrite),
        uid_b=w(bonds.uid_b, neighbor_uid, rewrite),
        slot_a=w(bonds.slot_a, child_slot, rewrite),
        slot_b=w(bonds.slot_b, neighbor_slot, rewrite),
        zone_a=w(bonds.zone_a, pass_zone, rewrite),
        zone_b=w(bonds.zone_b, neighbor_zone, rewrite),
        child_to_child=w(bonds.child_to_child, false, rewrite),
        # Every touched bond is stamped, pure drops included: the stamp
        # reopens filter_bonds' settled gate.
        created_step=w(bonds.created_step, step_t.expand(B), touches),
        rel_orientation=w(bonds.rel_orientation, rel, rewrite),
        anchor_a=w(bonds.anchor_a, zeros3, rewrite),
        anchor_b=w(bonds.anchor_b, zeros3, rewrite),
        anchors_set=w(bonds.anchors_set, false, rewrite),
    )

    # Inserts: ZoneC duplicates (both children keep) + the A↔B bond.
    dup = touches & (parent_zone == ZONE_C) & bool(keep_a and keep_b)
    # Free slots: a stable argsort puts inactive rows first, ascending.
    perm = torch.sort(b.active.to(torch.int32), stable=True).indices
    n_free = torch.sum(~b.active)
    dup_rank = torch.cumsum(dup.to(torch.int32), 0) - 1
    dup_ok = dup & (dup_rank < n_free)
    n_dup = torch.sum(dup_ok)
    target = torch.where(dup_ok, perm[torch.clamp(dup_rank, 0, B - 1).long()],
                         B)

    q_b = rot[torch.clamp(slot_b_t, 0, N - 1).long()]
    rel_dup = quat.mul(quat.conjugate(q_b), q_neighbor)
    full_i32 = lambda v: torch.as_tensor(v, **i32).expand(B)  # noqa: E731
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    b = b.replace_fields(
        active=_padded_set(b.active, target, ones),
        uid_a=_padded_set(b.uid_a, target, full_i32(uid_b_t)),
        uid_b=_padded_set(b.uid_b, target, neighbor_uid),
        slot_a=_padded_set(b.slot_a, target, full_i32(slot_b_t)),
        slot_b=_padded_set(b.slot_b, target, neighbor_slot),
        zone_a=_padded_set(b.zone_a, target, pass_zone),
        zone_b=_padded_set(b.zone_b, target, neighbor_zone),
        child_to_child=_padded_set(b.child_to_child, target, false),
        created_step=_padded_set(b.created_step, target, full_i32(step_t)),
        rel_orientation=_padded_set(b.rel_orientation, target, rel_dup),
        anchor_a=_padded_set(b.anchor_a, target, zeros3),
        anchor_b=_padded_set(b.anchor_b, target, zeros3),
        anchors_set=_padded_set(b.anchors_set, target, false),
    )
    dropped = torch.sum(dup & ~dup_ok).to(torch.int32)

    # Child-A↔child-B bond (CAM:504-509): ZoneC/ZoneC, child_to_child.
    ab_slot = perm[torch.clamp(n_dup, 0, B - 1)]
    ab_ok = bool(make_adhesion) & (n_dup < n_free)
    ab_idx = torch.where(ab_ok, ab_slot, B).reshape(1)
    q_a_new = rot[torch.clamp(slot_a_t, 0, N - 1).long()]
    rel_ab = quat.mul(quat.conjugate(q_a_new), q_b)

    def set1(arr, value):
        v = torch.as_tensor(value, dtype=arr.dtype, device=dev)
        return _padded_set(arr, ab_idx, v.reshape(1, *arr.shape[1:]))

    b = b.replace_fields(
        active=set1(b.active, True),
        uid_a=set1(b.uid_a, uid_a_t),
        uid_b=set1(b.uid_b, uid_b_t),
        slot_a=set1(b.slot_a, slot_a_t),
        slot_b=set1(b.slot_b, slot_b_t),
        zone_a=set1(b.zone_a, ZONE_C),
        zone_b=set1(b.zone_b, ZONE_C),
        child_to_child=set1(b.child_to_child, True),
        created_step=set1(b.created_step, step_t),
        rel_orientation=set1(b.rel_orientation, rel_ab),
        anchor_a=set1(b.anchor_a, torch.zeros(3)),
        anchor_b=set1(b.anchor_b, torch.zeros(3)),
        anchors_set=set1(b.anchors_set, False),
    )
    dropped = dropped + (bool(make_adhesion) & ~ab_ok).to(torch.int32)
    return b, dropped
