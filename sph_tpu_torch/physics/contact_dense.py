"""Contact forces on the colony's dense [Z, Y, X·K] layout — the
counterpart of sph_tpu.physics.contact_dense.

Layout (the JAX package's, unchanged, so every array compares element by
element with the reference): Z planes × Y rows of cells, each row's X cells
holding K slots side by side on the minor axis (L = X·K), one sentinel
margin cell on every side, Y padded to a multiple of 8 and L to a multiple
of 128 with sentinel cells. A stencil partner is (dz, dy, o) with the lane
offset o = dx·K + dm; offsets that reach a dx = ±2 cell reject
arithmetically (cell ≥ contact reach).

Per call: cell id → stable sort carrying the 11 particle columns → rank in
cell (`_rank_and_slots`, or the slots kernel on the card) → placement into
the planar fields (`_scatter_sorted`, or K5 on the card) → the
full-stencil own-only sweep (`_sweep_plain`, or K4 on the card) → one row
gather back to particle order (`gather_back`, or the gather kernel on the
card). The sweep sums
`contact_pair_terms` over `contact_variants` in their order, so the kernel
K4 and the plain version add the same terms in the same order.

Not ported: `tile_windows`, `window_overrun`, `_env_from_flat` and the
scatter-fallback `lax.cond` — TPU machinery of the expand kernel's input
windows; a direct GPU placement needs no windows.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.ops.grid import cell_index
from sph_tpu_torch.physics.contact import alive_mask
from sph_tpu_torch.sph.dense import SENTINEL
from sph_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class ContactSpec:
    """Static colony-grid geometry for the [Z, Y, X·K] layout. nz/ny/nx
    count cells including the sentinel margin ring; ny is padded to a
    multiple of 8 and nx to make L = nx_pad·k a multiple of 128."""

    nz: int
    ny: int
    nx: int            # real cells along x (incl. margins)
    nx_pad: int        # padded row length in cells
    k: int             # slots per cell
    cell: float        # cell edge ≥ contact reach (max_radius)
    origin: tuple[float, float, float]  # world corner of cell (0, 0, 0)

    @property
    def L(self) -> int:
        return self.nx_pad * self.k

    @property
    def slots(self) -> int:
        return self.nz * self.ny * self.L

    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.L)


def make_contact_spec(params: SimParams, k: int = 2,
                      cell_factor: float = 1.05) -> ContactSpec:
    """Colony-grid geometry: cell = max_radius·cell_factor ≥ the contact
    reach eff_i + eff_j; domain the spawn sphere [−R, R]³ plus the margin
    ring (SimulateParticles.compute:16-18, 102-105)."""
    cell = float(params.max_radius) * cell_factor
    r = float(params.spawn_radius)
    n = max(1, int(-(-2.0 * r // cell))) + 2
    origin = (-r - cell, -r - cell, -r - cell)
    ny = -(-n // 8) * 8
    lane_q = 128 // math.gcd(k, 128)
    nx_pad = -(-n // lane_q) * lane_q
    return ContactSpec(nz=n, ny=ny, nx=n, nx_pad=nx_pad, k=k, cell=cell,
                       origin=origin)


def contact_variants(spec: ContactSpec):
    """The full-stencil variants [(dz, dy, o)] in sweep order (o, then dz,
    then dy): o ∈ [−(2K−1), 2K−1], every (dz, dy), without (0, 0, 0).
    The plain sweep and K4 both add their terms in this order."""
    K = spec.k
    out = []
    for o in range(-(2 * K - 1), 2 * K):
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if o == 0 and dz == 0 and dy == 0:
                    continue
                out.append((dz, dy, o))
    return out


def contact_pair_terms(params: SimParams,
                       cx, cy, cz, cvx, cvy, cvz, cox, coy, coz, crad,
                       qx, qy, qz, qvx, qvy, qvz, qox, qoy, qoz, qrad):
    """One candidate pair's own-side (force[3], torque[3]) — the model of
    physics.contact.pair_contact (compute:211-309) in the JAX package's
    exact operation order (K4 repeats it operation for operation).
    Sentinel partners self-reject through the overlap test."""
    eff_i = crad * 0.5
    eff_j = qrad * 0.5
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    rinv = torch.rsqrt(torch.clamp(r2, min=1e-24))
    dist = r2 * rinv
    sum_r = eff_i + eff_j
    overlap = sum_r - dist
    in_contact = (overlap > params.contact_epsilon).to(torch.float32)

    ux, uy, uz = dx * rinv, dy * rinv, dz * rinv
    inv_sum = 1.0 / torch.clamp(sum_r, min=1e-12)
    overlap_falloff = torch.clamp(overlap * inv_sum, 0.0, 1.0)
    falloff = torch.clamp(1.0 - dist * inv_sum, 0.0, 1.0)
    fmag = falloff * params.repulsion_strength * overlap_falloff * in_contact
    fx, fy, fz = ux * fmag, uy * fmag, uz * fmag

    # Relative surface velocity with the ω×arm terms (compute:263-273);
    # arm_i = −u·eff_i (own side), arm_j = +u·eff_j.
    sivx = cvx + (coy * (-uz * eff_i) - coz * (-uy * eff_i))
    sivy = cvy + (coz * (-ux * eff_i) - cox * (-uz * eff_i))
    sivz = cvz + (cox * (-uy * eff_i) - coy * (-ux * eff_i))
    sjvx = qvx + (qoy * (uz * eff_j) - qoz * (uy * eff_j))
    sjvy = qvy + (qoz * (ux * eff_j) - qox * (uz * eff_j))
    sjvz = qvz + (qox * (uy * eff_j) - qoy * (ux * eff_j))
    rvx, rvy, rvz = sivx - sjvx, sivy - sjvy, sivz - sjvz
    rn = rvx * ux + rvy * uy + rvz * uz
    tx, ty, tz = rvx - ux * rn, rvy - uy * rn, rvz - uz * rn
    slip2 = tx * tx + ty * ty + tz * tz
    # A NORMAL f32 floor (a denormal one flushes to 0 on flushing hardware,
    # and rsqrt(0) = inf makes no-slip lanes 0·inf = NaN).
    slip_inv = torch.rsqrt(torch.clamp(slip2, min=1e-30))
    slip = slip2 * slip_inv
    slipping = in_contact * (slip > params.slip_epsilon).to(torch.float32)

    torque_input = torch.abs(slip * params.torque_factor)
    # x^1.25 as x·sqrt(sqrt(x)) (the form physics/contact.py uses too).
    friction_mag = torch.clamp(
        torque_input * torch.sqrt(torch.sqrt(torque_input)), max=10.0)

    # τ_own = cross(u, f̂·mag)·falloff²·mult·eff_i (compute:282-294).
    scale = (overlap_falloff * overlap_falloff
             * params.rolling_contact_radius_multiplier
             * friction_mag * slip_inv * slipping * eff_i)
    bx = (uy * tz - uz * ty) * scale
    by = (uz * tx - ux * tz) * scale
    bz = (ux * ty - uy * tx) * scale
    return fx, fy, fz, bx, by, bz


# Fill per packed field (px, py, pz, vx, vy, vz, ox, oy, oz, rad) and the
# occupancy plane's. The sentinel RADIUS is large-negative, so every pair
# with a sentinel lane has overlap < 0 — even two sentinel lanes at the
# same position — and K4 can skip it.
FIELD_FILLS = (SENTINEL, SENTINEL, SENTINEL,
               0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0e3)
OCC_FILL = 0.0
PACK_FILLS = FIELD_FILLS + (OCC_FILL,)


def contact_screen(params: SimParams, cx, cy, cz, crad, qx, qy, qz, qrad):
    """Contact MARGIN of one stencil offset: overlap − contact_epsilon with
    contact_pair_terms' overlap arithmetic. A pair whose margin is ≤ 0
    contributes exact ±0 to every component, and the accumulators start at
    +0 and never hold −0, so skipping such a pair keeps the sum's bits
    (the skip K4 makes)."""
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    rinv = torch.rsqrt(torch.clamp(r2, min=1e-24))
    dist = r2 * rinv
    overlap = crad * 0.5 + qrad * 0.5 - dist
    return overlap - params.contact_epsilon


def gather_back(comps_flat, slot_of, overflow):
    """ONE row gather of the stacked per-slot components back to particle
    order. Returns (force [N, 3], torque [N, 3], overflow). The plain
    version of the gather kernel (ops/contact_slots.py `gather_back`)."""
    table = torch.stack(comps_flat, dim=-1)              # [slots, 6]
    n = table.shape[0]
    idx = torch.clamp(slot_of, max=n - 1).long()
    valid = (slot_of < n)[:, None].to(torch.float32)
    ft = table[idx] * valid
    return ft[:, :3], ft[:, 3:], overflow


def _gather_back(comps, slot_of, overflow, kernel: bool = False):
    """`gather_back` of the sweep's six planes; kernel=True takes it
    through ops.contact_slots.gather_back (the gather kernel on a CUDA
    tensor, the plain version on a CPU one); both give the same bits."""
    comps_flat = [c.reshape(-1) for c in comps]
    if kernel:
        from sph_tpu_torch.ops import contact_slots

        return contact_slots.gather_back(comps_flat, slot_of, overflow)
    return gather_back(comps_flat, slot_of, overflow)


@functools.lru_cache(maxsize=16)
def _binning_constants(spec: ContactSpec, device: torch.device):
    """(origin [3], cell (0-dim), upper cell bound [3]) as f32 tensors on
    `device`, made once: a tensor built from host values is a copy that
    waits for the device."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(spec.origin, **f32), torch.tensor(spec.cell, **f32),
            torch.tensor((spec.nx - 2, spec.ny - 2, spec.nz - 2), **f32))


def _cell_ids(state: SimState, spec: ContactSpec):
    """Per-particle cell id; dead rows get the past-the-end id
    nz·ny·nx_pad. Cell coordinates are clamped into the interior
    [1, dim−2] so the margin ring stays sentinel-only (an out-of-domain
    division child bins into the nearest edge cell, compute:104). The
    quotient divides by a 0-dim tensor (a Python-scalar divisor becomes a
    reciprocal multiply on CUDA) and converts as `ops.grid.cell_index`
    does: NaN → 0, then the clamp, then the cast, so a NaN position bins
    as in JAX and an out-of-domain one never overflows int32."""
    org, cell, hi = _binning_constants(spec, state.device)
    cc = cell_index(torch.div(state.pos - org, cell), 1.0, hi)
    ix, iy, iz = cc.unbind(-1)
    cid = (iz * spec.ny + iy) * spec.nx_pad + ix
    dead = torch.full_like(cid, spec.nz * spec.ny * spec.nx_pad)
    return torch.where(alive_mask(state), cid, dead)


def _rank_and_slots(cid_s, order, spec: ContactSpec):
    """Bookkeeping on the SORTED cell ids: rank in cell (cummax of run
    starts), fits mask, flat slot targets (drop bucket = spec.slots), the
    placement key cid·K + min(rank, K − 1) (nondecreasing, equal to flat
    where a row fits: K5 looks its rows up by it, `targets_of_keys`),
    counted overflow and the particle-order slot_of. The plain version of
    the slots kernel (ops/contact_slots.py `rank_and_slots`)."""
    N = cid_s.shape[0]
    K = spec.k
    slots = spec.slots
    dev = cid_s.device
    alive_s = cid_s < spec.nz * spec.ny * spec.nx_pad
    i = torch.arange(N, dtype=torch.int32, device=dev)
    is_start = torch.ones(N, dtype=torch.bool, device=dev)
    is_start[1:] = cid_s[1:] != cid_s[:-1]
    starts = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    rank = i - starts
    fits = alive_s & (rank < K)
    overflow = torch.sum(alive_s & ~fits).to(torch.int32)
    flat = cid_s * K + rank                    # (z·ny + y)·L + x·K + m
    key = (cid_s * K + torch.clamp(rank, max=K - 1)).to(torch.int32)
    flat = torch.where(fits, flat, slots).to(torch.int32)
    slot_of = torch.full((N,), slots, dtype=torch.int32, device=dev)
    slot_of[order] = flat                      # order is a permutation
    return flat, fits, key, overflow, slot_of


def targets_of_keys(key, slots: int):
    """(flat, fits) from the placement keys: a row fits when its key is
    below `slots` (a dead row's is not) and differs from the key of the row
    before (a cell's overflow rows repeat the key of its rank-(K − 1) row);
    flat is then the key, else the drop bucket `slots`. The same targets as
    `_rank_and_slots`."""
    prev = torch.cat([key[:1] - 1, key[:-1]])
    fits = (key < slots) & (key != prev)
    return torch.where(fits, key, slots).to(torch.int32), fits


def _sort_with_payload(state: SimState, spec: ContactSpec,
                       kernel: bool = False):
    """The pack sort: a stable sort of the cell ids and ONE row gather of
    the 11 particle columns (pos, vel, ang_vel, radius, occupancy 1.0) —
    bitwise the permutation of the JAX package's payload lax.sort. Returns
    (rows [N, 11] in sorted order, flat, fits, key, overflow, slot_of).
    kernel=True takes the bookkeeping through
    ops.contact_slots.rank_and_slots (its kernel on a CUDA tensor,
    `_rank_and_slots` on a CPU one); both give the same bits."""
    N = state.capacity
    cid = _cell_ids(state, spec)
    cid_s, order = torch.sort(cid, stable=True)
    ones = torch.ones((N, 1), dtype=torch.float32, device=state.device)
    tbl = torch.cat([state.pos, state.vel, state.ang_vel,
                     state.radius[:, None], ones], dim=1)
    rows = tbl[order]
    if kernel:
        from sph_tpu_torch.ops.contact_slots import rank_and_slots

        return (rows, *rank_and_slots(cid_s, order, spec))
    return (rows, *_rank_and_slots(cid_s, order, spec))


def _scatter_sorted(cols, fills, flat, fits, spec: ContactSpec):
    """Column scatters of already-sorted columns into planar [Z, Y, L]
    fields — the plain version of K5. Rows that do not fit go to the drop
    slot `spec.slots` with their field's fill and are sliced off."""
    slots = spec.slots
    flat = flat.long()
    out = []
    for col, fill in zip(cols, fills):
        plane = torch.full((slots + 1,), fill, dtype=torch.float32,
                           device=col.device)
        plane[flat] = torch.where(fits, col, fill)
        out.append(plane[:slots].view(spec.shape()))
    return out


def _pack_args(state: SimState, spec: ContactSpec, expand: bool = False):
    """The pack: (fields [10][Z, Y, L], occ, slot_of, overflow).
    expand=True takes the bookkeeping and the placement through the kernel
    wrappers, ops.contact_slots.rank_and_slots and ops.expand.expand_rows
    (the slots kernel and K5 on a CUDA tensor, `_rank_and_slots` and
    `_scatter_sorted` on a CPU one); both give the same bits."""
    rows, flat, fits, key, overflow, slot_of = _sort_with_payload(
        state, spec, kernel=expand)
    if expand:
        from sph_tpu_torch.ops.expand import expand_rows

        out = expand_rows(rows, key, PACK_FILLS, spec)
        arrs = [out[c].view(spec.shape()) for c in range(11)]
    else:
        arrs = _scatter_sorted(rows.unbind(1), PACK_FILLS, flat, fits, spec)
    return tuple(arrs[:10]), arrs[10], slot_of, overflow


def _sweep_plain(fields, pair_fn, ncomp: int, spec: ContactSpec):
    """The plain full-stencil own-only sweep (the counterpart of the JAX
    package's `_sweep_xla`): per variant, in contact_variants' order, every
    field rolled to its partner and the pair terms added to +0-started
    accumulators."""
    F = torch.stack(fields)                              # [nf, Z, Y, L]
    accs = [torch.zeros_like(fields[0]) for _ in range(ncomp)]
    for dz, dy, o in contact_variants(spec):
        q = torch.roll(F, (-dz, -dy, -o), (1, 2, 3))
        ts = pair_fn(*fields, *q.unbind(0))
        accs = [a + t for a, t in zip(accs, ts)]
    return accs


def contact_forces_dense(state: SimState, params: SimParams,
                         spec: ContactSpec | None = None):
    """Per-particle (force [N, 3], torque [N, 3], overflow) through the
    dense full-stencil sweep. Particles that overflow their cell's K slots
    exert and receive no contact force this step and are counted.
    `use_pallas` (the JAX field name) routes the pack, the sweep and the
    gather back through the kernel wrappers: the slots kernel and K5, K4,
    the gather kernel."""
    if spec is None:
        spec = make_contact_spec(params, k=params.dense_k,
                                 cell_factor=params.dense_cell_factor)
    with span("sph.contact.pack"):
        fields, occ, slot_of, overflow = _pack_args(
            state, spec, expand=params.use_pallas)
    with span("sph.contact.sweep"):
        if params.use_pallas:
            from sph_tpu_torch.ops.contact import contact_sweep

            comps = contact_sweep(fields, occ, params, spec)
        else:
            comps = _sweep_plain(
                fields, lambda *a: contact_pair_terms(params, *a), 6, spec)
    with span("sph.contact.gather"):
        return _gather_back(comps, slot_of, overflow,
                            kernel=params.use_pallas)
