"""Spatial-hash neighbour grid — the counterpart of sph_tpu.ops.grid: the
sort-based, race-free replacement for the reference's atomic linked-list
grid (ClearGrid/BuildHashGrid/ApplySPHForces traversal,
SimulateParticles.compute:102-116, :196-209, :228-233).

Particles are sorted by cell id (stable: ties in slot order), ranked within
their cell and placed into dense bins [n_cells, K]; the 27-cell stencil is
then a gather of [27·K] candidates per particle, summed along that axis (no
atomics). Overflow (a cell fuller than K) is counted, never silent.

Geometry is the reference's: coord = clip(trunc((pos − origin)/cell), 0,
dim − 1) with the linear hash x + y·dim + z·dim² (compute:102-109).
`cell_index` is the float → int32 conversion every binning of the port
uses (this grid, `sph.dense.bin_coord`, `physics.contact_dense._cell_ids`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from sph_tpu_torch.core.types import SimParams, SimState


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (the reference hardcodes 32³ × 4.0)."""

    dim: tuple[int, int, int]
    cell_size: float
    origin: tuple[float, float, float]  # world position of cell (0,0,0) corner
    cell_capacity: int

    @property
    def n_cells(self) -> int:
        return self.dim[0] * self.dim[1] * self.dim[2]

    @staticmethod
    def from_params(params: SimParams) -> "GridSpec":
        d = params.grid_dim
        r = params.spawn_radius
        return GridSpec(
            dim=(d, d, d),
            cell_size=params.grid_cell_size,
            origin=(-r, -r, -r),
            cell_capacity=params.cell_capacity,
        )


def cell_index(q: torch.Tensor, lo, hi) -> torch.Tensor:
    """A float cell quotient as an int32 coordinate in [lo, hi], as XLA
    converts and then clips: NaN → 0 first (XLA's convert), then the clamp,
    then the cast. Clamping before the cast keeps ±inf and sentinel lanes
    out of the undefined float → int range; for integer bounds it equals
    truncate-then-clip. `lo`/`hi` are numbers or f32 tensors."""
    q = torch.nan_to_num(q, nan=0.0)
    return torch.clamp_max(torch.clamp_min(q, lo), hi).to(torch.int32)


@functools.lru_cache(maxsize=16)
def _constants(spec: GridSpec, device: torch.device):
    """(origin [3], cell (0-dim), dim − 1 [3] as f32, dims [3] as int32) on
    `device`, made once: a tensor built from host values is a copy that
    waits for the device."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(spec.origin, **f32),
            torch.tensor(spec.cell_size, **f32),
            torch.tensor([d - 1 for d in spec.dim], **f32),
            torch.tensor(spec.dim, dtype=torch.int32, device=device))


def cell_coords(pos: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Clamped int32 cell coordinates [..., 3] (compute:102-105). The
    quotient divides by a 0-dim tensor: a Python-scalar divisor becomes a
    reciprocal multiply on CUDA, which is not the IEEE quotient JAX takes."""
    org, cell, top, _ = _constants(spec, pos.device)
    return cell_index(torch.div(pos - org, cell), 0.0, top)


def cell_ids(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Linear hash x + y·dimx + z·dimx·dimy (compute:107-109)."""
    dx, dy, _ = spec.dim
    return coords[..., 0] + coords[..., 1] * dx + coords[..., 2] * (dx * dy)


@dataclass
class Bins:
    """Dense per-cell particle index table: idx [n_cells, K] int32 (−1 =
    empty lane), counts [n_cells] the true occupancy (may exceed K), and
    overflow, the particles that did not fit their cell."""

    idx: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def _sorted_starts(cid: torch.Tensor, n_cells: int):
    """(order, sorted ids, starts [C+1]): the stable sort by cell id and
    each cell's first sorted row."""
    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    queries = torch.arange(n_cells + 1, dtype=cid.dtype, device=cid.device)
    starts = torch.searchsorted(cid_sorted, queries, side="left",
                                out_int32=True)
    return order, cid_sorted, starts


def build_bins(pos: torch.Tensor, alive: torch.Tensor,
               spec: GridSpec) -> Bins:
    """Sort + rank + place: the deterministic replacement for the
    InterlockedExchange list push (compute:207). Every row that does not
    fit (dead, or past K in its cell) is written to the one trash entry
    C·K, which is sliced away: those duplicate writes have no defined
    winner and no reader; every other target is written once."""
    N = pos.shape[0]
    C = spec.n_cells
    K = spec.cell_capacity
    dev = pos.device

    cid = cell_ids(cell_coords(pos, spec), spec)
    cid = torch.where(alive, cid, C)          # dead rows to the trash cell
    order, cid_sorted, starts = _sorted_starts(cid, C)
    counts = starts[1:] - starts[:-1]
    rank = (torch.arange(N, dtype=torch.int32, device=dev)
            - starts[torch.clamp_max(cid_sorted, C).long()])
    real = cid_sorted < C
    fits = real & (rank < K)
    flat_target = torch.where(fits, cid_sorted * K + rank, C * K)
    idx_flat = torch.full((C * K + 1,), -1, dtype=torch.int32, device=dev)
    idx_flat[flat_target.long()] = order.to(torch.int32)
    overflow = torch.sum(real & (rank >= K)).to(torch.int32)
    return Bins(idx=idx_flat[:C * K].view(C, K), counts=counts,
                overflow=overflow)


@functools.lru_cache(maxsize=16)
def _stencil_offsets(device: torch.device) -> torch.Tensor:
    """[27, 3] int32 offsets in (x, y, z), x slowest (meshgrid "ij")."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)


def _stencil_cells(coords: torch.Tensor, spec: GridSpec):
    """(cell ids [Q, 27] of the clamped stencil, in-bounds mask [Q, 27])."""
    dims = _constants(spec, coords.device)[3]
    nb = coords[:, None, :] + _stencil_offsets(coords.device)[None]
    in_bounds = torch.all((nb >= 0) & (nb < dims), dim=-1)
    nb = torch.minimum(torch.clamp_min(nb, 0), dims - 1)
    return cell_ids(nb, spec).long(), in_bounds


def stencil_candidates(coords: torch.Tensor, bins: Bins,
                       spec: GridSpec) -> torch.Tensor:
    """For each query coordinate, the 27-cell stencil's bin contents:
    candidate particle indices [Q, 27·K] int32 (−1 = empty or out of
    bounds). The reference walks the same stencil per thread
    (compute:228-233)."""
    nb_cid, in_bounds = _stencil_cells(coords, spec)
    cand = bins.idx[nb_cid]                                 # [Q, 27, K]
    cand = torch.where(in_bounds[..., None], cand, -1)
    return cand.reshape(coords.shape[0], -1)


# ---------------------------------------------------------------------------
# Sorted layout: the fluid path reorders particle data by cell every step, so
# cell c's members are the sorted rows [starts[c], starts[c] + counts[c]) and
# the bins need no placement.
# ---------------------------------------------------------------------------


@dataclass
class SortedBins:
    """Cell ranges over the SORTED particle order: starts [C+1], counts
    [C], and overflow, the particles past cell_capacity (missed as
    neighbours; counted, never silent)."""

    starts: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def sort_by_cell(pos: torch.Tensor, spec: GridSpec):
    """(order, SortedBins): `order` is the stable permutation that sorts
    the particles by cell id."""
    cid = cell_ids(cell_coords(pos, spec), spec)
    order, _, starts = _sorted_starts(cid, spec.n_cells)
    counts = starts[1:] - starts[:-1]
    overflow = torch.sum(torch.clamp_min(counts - spec.cell_capacity, 0))
    return order, SortedBins(starts=starts, counts=counts,
                             overflow=overflow.to(torch.int32))


def stencil_candidates_sorted(coords: torch.Tensor, bins: SortedBins,
                              spec: GridSpec) -> torch.Tensor:
    """For each query coordinate: the sorted-row indices of all particles
    in its 3×3×3 stencil, [Q, 27·K] int32 (−1 = empty lane or out of
    bounds)."""
    K = spec.cell_capacity
    nb_cid, in_bounds = _stencil_cells(coords, spec)
    lane = torch.arange(K, dtype=torch.int32, device=coords.device)
    cand = bins.starts[nb_cid][..., None] + lane            # [Q, 27, K]
    valid = in_bounds[..., None] & (lane < bins.counts[nb_cid][..., None])
    cand = torch.where(valid, cand, -1)
    return cand.reshape(coords.shape[0], -1)


def row_blocks(N: int, row_block: int, device):
    """The row blocks of the candidate sums: blocks of R = min(row_block,
    N) rows, the last padded with copies of row N − 1 whose results are
    sliced off — the JAX package's blocks, except that where N <
    row_block it pads its one block to row_block rows, all sliced off."""
    R = min(row_block, N)
    base = torch.arange(R, device=device)
    for i0 in range(0, N, R):
        yield torch.clamp_max(base + i0, N - 1)


def block_contact_sums(state: SimState, params: SimParams,
                       rows: torch.Tensor, cand: torch.Tensor,
                       alive: torch.Tensor):
    """One row block's contact sums (force [R, 3], torque [R, 3]) over
    its candidates `cand` [R, 27·K]: the row gathers, the pair terms and
    the sums along the candidate axis."""
    from sph_tpu_torch.physics.contact import pair_contact

    cj = torch.clamp(cand, 0, state.capacity - 1).long()
    valid = (cand >= 0) & (cand != rows[:, None]) & alive[rows][:, None]
    f, t = pair_contact(
        state.pos[rows][:, None], state.vel[rows][:, None],
        state.ang_vel[rows][:, None], state.radius[rows][:, None],
        state.pos[cj], state.vel[cj], state.ang_vel[cj],
        state.radius[cj], valid, params)
    return f.sum(dim=1), t.sum(dim=1)


def contact_forces_grid(state: SimState, params: SimParams,
                        row_block: int = 2048):
    """Grid-accelerated contact sums; they equal contact_forces_bruteforce
    whenever the interaction radius fits one cell.

    Returns (force, torque, overflow): particles beyond a cell's capacity K
    are absent from the candidate bins (they exert and receive no force
    this step) but counted."""
    from sph_tpu_torch.physics.contact import alive_mask

    N = state.capacity
    spec = GridSpec.from_params(params)
    alive = alive_mask(state)
    bins = build_bins(state.pos, alive, spec)
    coords = cell_coords(state.pos, spec)
    forces, torques = [], []
    for rows in row_blocks(N, row_block, state.device):
        cand = stencil_candidates(coords[rows], bins, spec)     # [R, 27K]
        f, t = block_contact_sums(state, params, rows, cand, alive)
        forces.append(f)
        torques.append(t)
    return (torch.cat(forces)[:N], torch.cat(torques)[:N], bins.overflow)
