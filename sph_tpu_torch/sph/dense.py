"""Dense cell-grid SPH engine (PyTorch) — the counterpart of
sph_tpu.sph.dense.

Layout, sentinels and pair algebra are the JAX package's, unchanged, so
every array compares element by element with the reference:

- Per-component arrays [Z, K(slots), C] f32 with C = Y·X the FUSED
  (row, cell) index; one margin cell rings the domain on every axis, so a
  fused-axis wrap between rows lands on a sentinel margin.
- Empty slots hold a SENTINEL position (1e9): every pair test rejects them
  arithmetically.
- The plain sweeps below (`density_pass`, `accel_pass`) are the plain
  versions of the hand-written kernels K1/K2 (`ops/fluid.py`) and keep the
  JAX twin's Newton-halved sweep order (whole-array rolls, mirror lumps,
  `combine_mirror_parts`), so the CPU comparison with the JAX twin stays
  tight. `rebin` is the plain version of K3 (`ops/rebin.py`).
- `step_passes` picks the step's passes on `params.use_pallas` (the JAX
  field name, kept because checkpoints carry it): True gives the wrappers
  in `ops/`, which launch the CUDA kernels on CUDA tensors and fall to
  these plain versions only for CPU tensors (the per-slot tail,
  `density_tail` and `_integrate`, is F2 and F1 in `ops/integrate.py`).

Differences from the JAX engine: no `jit` (a Python substep loop replaces
`lax.scan`, a host `if` replaces `lax.cond`), and no tile-occupancy flags
(the CUDA sweeps gate empty bands of rows themselves).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from sph_tpu_torch.ops import obstacle_pushed, rebin_peak
from sph_tpu_torch.ops.grid import cell_index
from sph_tpu_torch.sph import kernels as KN
from sph_tpu_torch.sph.model import (
    SPHParams,
    SPHState,
    eos_pressure,
    obstacle_push,
)
from sph_tpu_torch.utils.profiling import span

SENTINEL = 1.0e9


@dataclass(frozen=True)
class DenseSpec:
    """Static dense-grid geometry.

    Storage is [n0, k, n1·n2]: `axis_map` names the WORLD axis stored in
    each layout dim (dim 0 = planes, dim 1 = rows inside the fused axis,
    dim 2 = cells inside a row). 3D uses (x, y, z); 2D uses (z=1, y, x).
    """

    n0: int            # layout dim 0 cells (incl. margins)
    n1: int            # layout dim 1 cells
    n2: int            # layout dim 2 cells (row length X)
    k: int             # slots per cell
    cell: float        # cell edge ≥ h
    origin: tuple[float, float, float]  # WORLD corner of cell (0,0,0)
    ndim: int
    axis_map: tuple[int, int, int] = (0, 1, 2)  # world axis per layout dim
    # Whether the stencil needs ±1 offsets along layout dims 0/1 (False when
    # the mapped world axis has a single real cell, e.g. z in 2D).
    stencil0: bool = True
    stencil1: bool = True

    @property
    def X(self) -> int:
        """Row length: fused-axis stride of one layout-dim-1 step."""
        return self.n2

    @property
    def C(self) -> int:
        """Fused minor-axis length (a multiple of 128)."""
        return self.n1 * self.n2

    def world_cells(self) -> tuple[int, int, int]:
        """Cell counts indexed by WORLD axis (x, y, z)."""
        dims = (self.n0, self.n1, self.n2)
        out = [1, 1, 1]
        for li, wa in enumerate(self.axis_map):
            out[wa] = dims[li]
        return tuple(out)


def make_dense_spec(params: SPHParams, k: int = 8,
                    cell_factor: float = 1.5) -> DenseSpec:
    cell = params.h * cell_factor
    lo, hi = params.bounds_min, params.bounds_max

    def ncells(a):
        extent = hi[a] - lo[a]
        return max(1, int(-(-extent // cell))) + 2  # +2 margin ring

    if params.ndim == 3:
        axis_map = (0, 1, 2)
        wc = [ncells(0), ncells(1), ncells(2)]
        origin = (lo[0] - cell, lo[1] - cell, lo[2] - cell)
    else:
        axis_map = (2, 1, 0)
        wc = [ncells(0), ncells(1), 1]
        origin = (lo[0] - cell, lo[1] - cell, 0.0)

    n0 = wc[axis_map[0]]
    # n1 a multiple of 8 and n2 of 16 ⇒ C = n1·n2 is a multiple of 128.
    w1 = wc[axis_map[1]]
    n1 = -(-w1 // 8) * 8 if w1 <= 8 else -(-w1 // 32) * 32
    n2 = -(-wc[axis_map[2]] // 16) * 16
    spec = DenseSpec(
        n0=n0, n1=n1, n2=n2, k=k, cell=cell, origin=origin,
        ndim=params.ndim, axis_map=axis_map,
        stencil0=wc[axis_map[0]] > 1, stencil1=wc[axis_map[1]] > 1,
    )
    if spec.C % 128:
        raise ValueError(f"fused axis {spec.C} is not a multiple of 128")
    return spec


@dataclass
class DenseFluidState:
    """SoA component arrays, each [Z, K, C=Y·X] f32, plus int32 counters
    (0-dim tensors on the same device)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    occ: torch.Tensor       # 1.0 where a particle lives
    rho: torch.Tensor
    prs: torch.Tensor
    dropped: torch.Tensor   # rebin overflow casualties (counted loudly)
    clamped: torch.Tensor   # cumulative rebin_vmax clamp hits
    step_count: torch.Tensor

    def replace_fields(self, **kw) -> "DenseFluidState":
        return dataclasses.replace(self, **kw)


def pack(state: SPHState, params: SPHParams, spec: DenseSpec,
         device="cuda") -> DenseFluidState:
    """Host-side packing of a flat particle state into the dense layout
    (numpy, identical to the JAX package's), moved to `device`."""
    pos = torch.as_tensor(state.pos).cpu().numpy()
    vel = torch.as_tensor(state.vel).cpu().numpy()
    n = pos.shape[0]
    org = np.asarray(spec.origin, np.float32)
    wc = np.array(spec.world_cells())
    # Clip into the INTERIOR [1, wc-2]: margin cells must stay sentinel.
    lo = np.minimum(1, wc - 1)
    hi = np.maximum(wc - 2, lo)
    cc = np.clip(((pos - org) / spec.cell).astype(np.int64), lo, hi)
    i0 = cc[:, spec.axis_map[0]]
    i1 = cc[:, spec.axis_map[1]]
    i2 = cc[:, spec.axis_map[2]]
    shape = (spec.n0, spec.k, spec.C)
    px = np.full(shape, SENTINEL, np.float32)
    py = np.full(shape, SENTINEL, np.float32)
    pz = np.full(shape, SENTINEL, np.float32)
    vx = np.zeros(shape, np.float32)
    vy = np.zeros(shape, np.float32)
    vz = np.zeros(shape, np.float32)
    occ = np.zeros(shape, np.float32)

    # Vectorized fill: sort by cell id, rank within cell → slot.
    cid = (i0 * spec.n1 + i1) * spec.n2 + i2
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    starts = np.searchsorted(cid_s, cid_s)  # first index of own cell run
    rank = np.arange(n) - starts
    if (rank >= spec.k).any():
        raise ValueError(
            f"pack overflow: {(rank >= spec.k).sum()} particles exceeded "
            f"k={spec.k}; raise dense_k or cell_factor"
        )
    z = i0[order]
    c = i1[order] * spec.n2 + i2[order]
    ps, vs = pos[order], vel[order]
    px[z, rank, c], py[z, rank, c], pz[z, rank, c] = ps[:, 0], ps[:, 1], ps[:, 2]
    vx[z, rank, c], vy[z, rank, c], vz[z, rank, c] = vs[:, 0], vs[:, 1], vs[:, 2]
    occ[z, rank, c] = 1.0

    def T(a):
        return torch.from_numpy(a).to(device)

    i32 = dict(dtype=torch.int32, device=device)
    return DenseFluidState(
        px=T(px), py=T(py), pz=T(pz), vx=T(vx), vy=T(vy), vz=T(vz),
        occ=T(occ),
        rho=torch.full(shape, params.rest_density, dtype=torch.float32,
                       device=device),
        prs=torch.zeros(shape, dtype=torch.float32, device=device),
        dropped=torch.zeros((), **i32),
        clamped=torch.zeros((), **i32),
        step_count=torch.zeros((), **i32),
    )


def unpack(dstate: DenseFluidState):
    """Flat (pos, vel, rho, prs, mask) views for tests / rendering / IO."""
    def flat(a):
        return a.reshape(-1)

    mask = flat(dstate.occ) > 0.5
    pos = torch.stack([flat(dstate.px), flat(dstate.py), flat(dstate.pz)], -1)
    vel = torch.stack([flat(dstate.vx), flat(dstate.vy), flat(dstate.vz)], -1)
    return pos, vel, flat(dstate.rho), flat(dstate.prs), mask


# ---------------------------------------------------------------------------
# Newton-symmetric pair sweep on the fused [Z, K, C] layout — the plain
# versions of kernels K1/K2. Sweep groups (mirror of (dz,dy,dx,m) is
# (−dz,−dy,−dx,(K−m)%K)), as in the JAX twin:
#   group A: (0,0,0), m ∈ [1, K/2]   — m=K/2 is its own mirror (own-only);
#            the m=0 self pair is peeled (density adds a constant).
#   group B: (0,0,+1), m ∈ [0,K)     — mirrors fold into the accumulator.
#   group C: (0,+1,dx∈{−1,0,+1})     — mirrors cover dy=−1 → m_row part.
#   group D: (+1,dy∈dysC,dx)         — mirrors cover dz=−1 → m_c[dy] parts.
# Mirror sign: density +1 (symmetric), accel −1 (Newton's third law).
# ---------------------------------------------------------------------------


def dys_c(spec: DenseSpec) -> tuple:
    """Group-D dy offsets (±1 only when layout dim 1 has a stencil)."""
    return (-1, 0, 1) if spec.stencil1 else (0,)


def density_self_term(params: SPHParams) -> float:
    """poly6 accumulator self term (h² − 0)³, evaluated in f32 with the same
    op order as the pair term t·t·t."""
    h2 = np.float32(params.h * params.h)
    return float(np.float32(np.float32(h2 * h2) * h2))


def density_pair_term(h2, cx, cy, cz, qx, qy, qz):
    """poly6 accumulator contribution of one candidate pair (pre-coeff)."""
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    t = torch.clamp_min(h2 - r2, 0.0)
    return (t * t * t,)


def accel_pair_terms(h, neg_m_spiky, visc_mc,
                     cx, cy, cz, cvx, cvy, cvz, cirho, cpr2,
                     qx, qy, qz, qvx, qvy, qvz, qirho, qpr2):
    """Pressure + viscosity contribution of one candidate pair on the own
    side; the mirror (force on the partner) is the exact negation. One
    rsqrt replaces sqrt + divide; relu(h − r) rejects out-of-support and
    sentinel pairs; r² > ε removes the self pair."""
    dx = cx - qx
    dy = cy - qy
    dz = cz - qz
    r2 = dx * dx + dy * dy + dz * dz
    rinv = torch.rsqrt(torch.clamp_min(r2, 1e-18))
    r = r2 * rinv
    not_self = (r2 > 1e-16).to(torch.float32)
    hr = torch.clamp_min(h - r, 0.0)
    hrm = hr * not_self
    cp = (neg_m_spiky * hrm) * hr * rinv * (cpr2 + qpr2)
    cv = (visc_mc * hrm) * (cirho * qirho)
    tx = cp * dx + cv * (qvx - cvx)
    ty = cp * dy + cv * (qvy - cvy)
    tz = cp * dz + cv * (qvz - cvz)
    return tx, ty, tz


def combine_mirror_parts(own, m_row, m_cs, spec: DenseSpec, sign: int):
    """Fold the mirror part arrays into the own-side accumulator: m_row
    holds group-C mirrors (destination row+1 → roll +X on the fused axis);
    m_cs[i] holds group-D mirrors for dy = dys_c(spec)[i] (destination
    plane+1, row+dy → roll +1 on dim 0 and +dy·X on the fused axis)."""
    out = own
    X = spec.X

    def fold(acc, part):
        return acc + part if sign > 0 else acc - part

    if spec.stencil1:
        out = fold(out, torch.roll(m_row, X, dims=2))
    if spec.stencil0:
        for dy, m in zip(dys_c(spec), m_cs):
            shifts = (1, dy * X) if dy else (1,)
            dims = (0, 2) if dy else (0,)
            out = fold(out, torch.roll(m, shifts, dims))
    return out


def sweep_groups(spec: DenseSpec):
    """The Newton-halved variant groups: (dz, dy, dxs, ms, mirror_ms, dest)
    where dest is 'acc' (mirrors fold into the accumulator), 'row' (m_row
    part) or dy (m_c part index)."""
    K = spec.k
    if K % 2:
        raise ValueError("dense_k must be even for the Newton slot split")
    allm = range(K)
    groups = [
        (0, 0, (0,), range(1, K // 2 + 1), range(1, K // 2), "acc"),
        (0, 0, (1,), allm, allm, "acc"),
    ]
    if spec.stencil1:
        groups.append((0, 1, (-1, 0, 1), allm, allm, "row"))
    if spec.stencil0:
        for dy in dys_c(spec):
            groups.append((1, dy, (-1, 0, 1), allm, allm, dy))
    return groups


def _sweep_plain(fields, pair_fn, ncomp, self_init, spec: DenseSpec,
                 sign: int):
    """Newton-symmetric fused sweep with whole-array rolls ([Z, K, C]:
    plane, slot, fused dy·X+dx); per (group, dx) one mirror lump
    accumulated in slot order then slot+lane-derolled — the accumulation
    order of the JAX twin."""
    shape = fields[0].shape
    X = spec.X
    zeros = torch.zeros(shape, dtype=torch.float32, device=fields[0].device)
    accs = [
        torch.full_like(zeros, self_init)
        if (i == 0 and self_init is not None) else zeros
        for i in range(ncomp)
    ]

    m_row = [zeros] * ncomp if spec.stencil1 else None
    m_cs = [[zeros] * ncomp for _ in dys_c(spec)] if spec.stencil0 else []
    dy_index = {dy: i for i, dy in enumerate(dys_c(spec))}

    for dz, dy, dxs, ms, mirror_ms, dest in sweep_groups(spec):
        for dx in dxs:
            o = dy * X + dx
            lumps = [zeros] * ncomp
            for m in ms:
                qs = [torch.roll(f, (-dz, -m, -o), (0, 1, 2)) for f in fields]
                ts = pair_fn(*fields, *qs)
                accs = [a + t for a, t in zip(accs, ts)]
                if m in mirror_ms:
                    lumps = [
                        lm + torch.roll(t, (m, dx), (1, 2))
                        for lm, t in zip(lumps, ts)
                    ]
            if dest == "acc":
                accs = [
                    a + lm if sign > 0 else a - lm
                    for a, lm in zip(accs, lumps)
                ]
            elif dest == "row":
                m_row = [p + lm for p, lm in zip(m_row, lumps)]
            else:
                i = dy_index[dest]
                m_cs[i] = [p + lm for p, lm in zip(m_cs[i], lumps)]
    return accs, m_row, m_cs


def density_raw(px, py, pz, params: SPHParams,
                spec: DenseSpec) -> torch.Tensor:
    """Scaled poly6 sum over every slot, before the occupancy fixup — the
    plain version of kernel K1 (ops.fluid.density_sweep)."""
    h2 = params.h * params.h
    accs, m_row, m_cs = _sweep_plain(
        (px, py, pz),
        lambda *a: density_pair_term(h2, *a),
        ncomp=1, self_init=density_self_term(params), spec=spec, sign=1,
    )
    acc = combine_mirror_parts(
        accs[0], m_row[0] if m_row else None,
        [m[0] for m in m_cs], spec, sign=1,
    )
    return params.particle_mass * KN.poly6_coeff(params.h, params.ndim) * acc


def density_fixup(rho, occ, params: SPHParams):
    """Empty lanes forced to rest density (keeps the EOS and force math
    NaN-free without masks); real lanes floored at 1e-6."""
    return torch.where(occ > 0.5, torch.clamp_min(rho, 1e-6),
                       params.rest_density)


def density_tail(raw, occ, params: SPHParams):
    """(ρ, p, p/ρ²) from the raw ρ over every slot: the fixup, the Tait EOS
    masked by occupancy and the operand of the force sweep — the lines of
    the JAX twin's dense_step between its two pair sweeps, and the plain
    version of kernel F2 (ops.integrate.density_tail)."""
    rho = density_fixup(raw, occ, params)
    prs = torch.where(occ > 0.5, eos_pressure(rho, params), 0.0)
    return rho, prs, prs / (rho * rho)    # empty lanes: 0 / rest² = 0


def density_pass(d: DenseFluidState, params: SPHParams,
                 spec: DenseSpec) -> torch.Tensor:
    """ρ over all lanes (the JAX twin's density_pass)."""
    return density_fixup(density_raw(d.px, d.py, d.pz, params, spec),
                         d.occ, params)


def accel_constants(params: SPHParams) -> tuple[float, float, float]:
    """(h, −m·spiky, μ·m·lap) as the Python floats the pair terms take."""
    m = params.particle_mass
    return (
        params.h,
        float(-m * KN.spiky_grad_coeff(params.h, params.ndim)),
        float(params.viscosity * m
              * KN.viscosity_lap_coeff(params.h, params.ndim)),
    )


def accel_raw(d: DenseFluidState, irho, pr2, params: SPHParams,
              spec: DenseSpec):
    """Pressure + viscosity acceleration over all lanes (garbage in empty
    lanes) from the 1/ρ and p/ρ² fields — the plain version of kernel K2
    (ops.fluid.accel_sweep)."""
    h, neg_m_spiky, visc_mc = accel_constants(params)

    def pair(*a):
        return accel_pair_terms(h, neg_m_spiky, visc_mc, *a)

    fields = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, irho, pr2)
    accs, m_row, m_cs = _sweep_plain(
        fields, pair, ncomp=3, self_init=None, spec=spec, sign=-1,
    )
    return tuple(
        combine_mirror_parts(
            accs[c], m_row[c] if m_row else None,
            [ms[c] for ms in m_cs], spec, sign=-1,
        )
        for c in range(3)
    )


def accel_pass(d: DenseFluidState, params: SPHParams, spec: DenseSpec):
    """Pressure + viscosity acceleration (the JAX twin's accel_pass)."""
    pr2 = d.prs / (d.rho * d.rho)     # empty lanes: 0 / rest² = 0
    return accel_raw(d, torch.reciprocal(d.rho), pr2, params, spec)


def rebin_vmax(params: SPHParams, spec: DenseSpec) -> float:
    """Hard speed limit keeping every particle reachable by the staged rebin
    and covered by the stencil between rebins: with cadence R, drift must
    stay within min(1 cell reachability, (cell − h)/2 stencil margin)."""
    if params.rebin_every == 1:
        return spec.cell / params.dt
    return (spec.cell - params.h) * 0.5 / (params.rebin_every * params.dt)


def _integrate(d: DenseFluidState, ax, ay, az, params: SPHParams,
               vmax: float, drag=None):
    """Gravity/obstacles + optional interactive drag + symplectic Euler
    (velocity clamped to the rebin reachability budget BEFORE the position
    update) + box walls.

    Returns (px, py, pz, vx, vy, vz, n_clamped, n_pushed), the counts
    int32 and 0-dim: n_clamped counts the lanes the vmax clamp actually
    limited, n_pushed the occupied lanes within h/2 of an obstacle's
    surface, where its push acts (once a lane, whatever the obstacles)."""
    dt = params.dt
    ay = ay - params.gravity
    occ = d.occ > 0.5
    if params.obstacles:
        pos = torch.stack([d.px, d.py, d.pz], dim=-1)
        oa, band = obstacle_push(pos, params)
        n_pushed = torch.sum(occ & band).to(torch.int32)
        ax = ax + oa[..., 0]
        ay = ay + oa[..., 1]
        az = az + oa[..., 2]
    else:
        n_pushed = torch.zeros((), dtype=torch.int32, device=occ.device)
    if drag is not None:
        ddx = d.px - drag.center[0]
        ddy = d.py - drag.center[1]
        ddz = d.pz - drag.center[2]
        in_r = (
            (ddx * ddx + ddy * ddy + ddz * ddz < drag.radius * drag.radius)
            & (drag.strength > 0.0)
        ).to(torch.float32)
        g = in_r * (drag.strength / params.particle_mass)
        ax = ax + (drag.target[0] - d.px) * g
        ay = ay + (drag.target[1] - d.py) * g
        az = az + (drag.target[2] - d.pz) * g
    vx = torch.where(occ, d.vx + ax * dt, 0.0)
    vy = torch.where(occ, d.vy + ay * dt, 0.0)
    vz = (torch.where(occ, d.vz + az * dt, 0.0) if params.ndim == 3
          else d.vz * 0)
    speed = torch.sqrt(vx * vx + vy * vy + vz * vz)
    # torch evaluates `python_float / tensor` as reciprocal-then-multiply
    # (two roundings); a 0-dim tensor divides once, as JAX does.
    vmax_t = torch.tensor(vmax, dtype=torch.float32, device=speed.device)
    scale = torch.clamp_max(
        torch.div(vmax_t, torch.clamp_min(speed, 1e-12)), 1.0)
    n_clamped = torch.sum(occ & (speed > vmax)).to(torch.int32)
    vx, vy, vz = vx * scale, vy * scale, vz * scale
    px = torch.where(occ, d.px + vx * dt, d.px)
    py = torch.where(occ, d.py + vy * dt, d.py)
    pz = torch.where(occ, d.pz + vz * dt, d.pz)

    lo = params.bounds_min
    hi = params.bounds_max
    ps, vs = [px, py, pz], [vx, vy, vz]
    for axis in range(3):
        if axis == 2 and params.ndim == 2:
            continue
        p, v = ps[axis], vs[axis]
        hit = occ & ((p < lo[axis]) | (p > hi[axis]))
        ps[axis] = torch.where(occ, torch.clamp(p, lo[axis], hi[axis]), p)
        vs[axis] = torch.where(hit, -params.boundary_damping * v, v)
    return (*ps, *vs, n_clamped, n_pushed)


def _compact_stage(fields, occ, own_coord, target_fn, axis_roll,
                   spec: DenseSpec):
    """One axis pass of the staged rebin: candidates are the own cell plus
    its two axis-neighbors; a candidate wants this cell when its target
    coordinate along the axis equals the cell's. Compacts the ≤3K wanting
    candidates into K slots (deterministic shift-major order).

    fields: [Z, K, C, F]; returns (fields, occ, dropped, demand), demand
    the most candidates that wanted one cell."""
    K = occ.shape[1]

    cand_blocks, want_blocks = [], []
    for step in (-1, 0, 1):
        sf = axis_roll(fields, step)
        so = axis_roll(occ, step)
        st = target_fn(sf, so)
        cand_blocks.append(sf)
        want_blocks.append((st == own_coord) & (so > 0.5))
    cand = torch.cat(cand_blocks, dim=1)      # [Z, 3K, C, F]
    wants = torch.cat(want_blocks, dim=1)     # [Z, 3K, C]

    rank = torch.cumsum(wants.to(torch.int32), dim=1) - 1
    demand = rank[:, -1].max() + 1
    keep = wants & (rank < K)
    dropped = torch.sum(wants & ~keep)
    # A particle whose target is > 1 cell away along this axis is claimed by
    # no cell in the sweep and would vanish silently: count it.
    tgt = target_fn(fields, occ)
    unreachable = (occ > 0.5) & (torch.abs(tgt - own_coord) > 1)
    dropped = dropped + torch.sum(unreachable)

    # Selected-sum compaction (K reductions): each output slot sums its one
    # selected candidate and +0s. The JAX XLA twin multiplies by a 0/1 mask
    # instead, so a non-finite candidate (0·NaN, 0·inf) writes NaN into
    # every slot of its window; its Pallas kernel, K3 and this version copy
    # it into its own slot only. Equal for finite values (−0 == +0).
    outs, occ_outs = [], []
    for k in range(K):
        mk = keep & (rank == k)                       # [Z, 3K, C]
        outs.append(torch.sum(torch.where(mk[..., None], cand, 0.0), dim=1))
        occ_outs.append(torch.sum(mk.to(torch.float32), dim=1))
    return (torch.stack(outs, dim=1), torch.stack(occ_outs, dim=1), dropped,
            demand)


def bin_coord(p, origin_w: float, cell: float, n_cells: int):
    """World cell coordinate clip(trunc((p − origin)/cell), lo, hi) on the
    interior [1, n−2] (margins stay sentinel). The divisor is a 0-dim tensor
    on p's device: dividing a CUDA tensor by a Python scalar multiplies by
    its reciprocal, which is not the IEEE quotient the kernel and JAX use.
    The conversion is `ops.grid.cell_index`'s: NaN → 0 before the clamp,
    as XLA converts before it clips, so a NaN position lands in cell lo as
    in JAX.
    """
    lo = min(1, n_cells - 1)
    hi = max(n_cells - 2, lo)
    q = torch.div(p - origin_w,
                  torch.tensor(cell, dtype=torch.float32, device=p.device))
    return cell_index(q, lo, hi)


def is_rebin_step(step: int, params: SPHParams) -> bool:
    """The rebin cadence, decided on the host: step % R == R − 1."""
    return step % params.rebin_every == params.rebin_every - 1


def rebin_stages(spec: DenseSpec) -> list[int]:
    """Layout dims the staged rebin sweeps, in order: in-row cells (2),
    rows (1), planes (0) — a dim without a stencil has nothing to move."""
    return [2] + ([1] if spec.stencil1 else []) + ([0] if spec.stencil0
                                                    else [])


def rebin(d: DenseFluidState, px, py, pz, vx, vy, vz, params: SPHParams,
          spec: DenseSpec, dim0_offset: int = 0,
          dim1_offset: int = 0) -> DenseFluidState:
    """Move particles to their new home cells, one axis at a time — the
    plain version of kernel K3 (ops.rebin.staged_rebin). Per-rebin drift is
    ≤ 1 cell (the vmax clamp), so each axis stage is a ≤3K→K masked
    compaction. Each particle's ρ and p (`d.rho`, `d.prs`, this step's)
    move with it, so the state's ρ stays the particles' after a rebin.
    Overflow is counted, never silent, and the most particles
    that sought one cell at any stage raise the device's demand peak
    (`ops.rebin_peak`), as K3 does.

    The cell coordinates compared with the targets are global: a sharded
    step rebins a halo-padded slab whose plane 0 is global plane
    `dim0_offset` and whose row 0 is global row `dim1_offset`."""
    Z, K, C = px.shape
    X = spec.X
    org = spec.origin
    wc = spec.world_cells()
    dev = px.device

    def coord_fn(world_axis):
        """Stage target: the world cell coordinate along the stage axis,
        from the candidates' positions (empty slots → impossible −9)."""
        def fn(sf, so):
            c = bin_coord(sf[..., world_axis], org[world_axis], spec.cell,
                          wc[world_axis])
            return torch.where(so > 0.5, c, -9)

        return fn

    fields = torch.stack([px, py, pz, vx, vy, vz, d.rho, d.prs], dim=-1)
    occ = d.occ
    iota_c = torch.arange(C, dtype=torch.int32, device=dev).reshape(1, 1, C)
    own = {
        2: iota_c % X,
        1: dim1_offset + torch.div(iota_c, X, rounding_mode="floor"),
        0: dim0_offset + torch.arange(Z, dtype=torch.int32,
                                      device=dev).reshape(Z, 1, 1),
    }

    def roll_c(step_cells):
        def f(a, s):
            return torch.roll(a, -s * step_cells, dims=2) if s else a
        return f

    def roll_planes(a, s):
        return torch.roll(a, -s, dims=0) if s else a

    rolls = {2: roll_c(1), 1: roll_c(X), 0: roll_planes}
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    peak = rebin_peak(dev)
    for stage in rebin_stages(spec):
        fields, occ, drp, demand = _compact_stage(
            fields, occ, own[stage], coord_fn(spec.axis_map[stage]),
            rolls[stage], spec,
        )
        dropped = dropped + drp
        peak.copy_(torch.maximum(peak, demand.to(torch.int32)))
    return finish_rebin(d, list(fields.unbind(-1)) + [occ], dropped,
                        params.rest_density)


def finish_rebin(d: DenseFluidState, fields, dropped,
                 rest_density: float) -> DenseFluidState:
    """Sentinel cleanup after the last stage: empty slots get sentinel
    positions, zero velocities and pressure, ρ0 and occ 0, as the density
    pass leaves empty lanes; `dropped` is added to the state's counter.
    fields: [px, py, pz, vx, vy, vz, rho, prs, occ]."""
    pxn, pyn, pzn, vxn, vyn, vzn, rhon, prsn, occn = fields
    empty = occn < 0.5
    return d.replace_fields(
        px=torch.where(empty, SENTINEL, pxn),
        py=torch.where(empty, SENTINEL, pyn),
        pz=torch.where(empty, SENTINEL, pzn),
        vx=torch.where(empty, 0.0, vxn),
        vy=torch.where(empty, 0.0, vyn),
        vz=torch.where(empty, 0.0, vzn),
        rho=torch.where(empty, rest_density, rhon),
        prs=torch.where(empty, 0.0, prsn),
        occ=torch.where(empty, 0.0, 1.0),
        dropped=d.dropped + dropped.to(torch.int32),
    )


class StepPasses(NamedTuple):
    """The dense step's passes, one signature each for the kernels'
    wrappers and the plain versions."""

    density: Callable     # (px, py, pz, occ, params, spec) -> raw ρ
    tail: Callable        # (raw, occ, params) -> (ρ, p, p/ρ²)
    accel: Callable       # (d, pr2, params, spec) -> (ax, ay, az)
    integrate: Callable   # (d, ax, ay, az, params, vmax, drag=None)
    rebin: Callable       # (d, px, py, pz, vx, vy, vz, params, spec)


def step_passes(params: SPHParams) -> StepPasses:
    """The kernels' wrappers in `ops/` (K1, F2, K2, F1, K3) when
    `params.use_pallas`, else the plain versions."""
    if params.use_pallas:
        from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
        from sph_tpu_torch.ops.integrate import density_tail as tail
        from sph_tpu_torch.ops.integrate import integrate
        from sph_tpu_torch.ops.rebin import staged_rebin

        return StepPasses(density_sweep, tail, accel_sweep, integrate,
                          staged_rebin)

    def density(px, py, pz, occ, params, spec):
        return density_raw(px, py, pz, params, spec)

    def accel(d, pr2, params, spec):
        return accel_raw(d, torch.reciprocal(d.rho), pr2, params, spec)

    return StepPasses(density, density_tail, accel, _integrate, rebin)


def dense_step(d: DenseFluidState, params: SPHParams, spec: DenseSpec,
               drag=None, rebin_now: bool | None = None) -> DenseFluidState:
    """One WCSPH step on the dense layout: density → EOS → forces →
    integrate (incl. optional interactive drag) → rebin when `rebin_now`.
    The step runs in a `sph.step` span and each phase in a `sph.fluid.`
    span (utils.profiling.span). The lanes the obstacles pushed are added
    to the device's running total, `ops.obstacle_pushed`.

    rebin_now: the host's cadence decision (`is_rebin_step` of the step
    index); None reads `d.step_count`, which waits for the device."""
    if rebin_now is None:
        rebin_now = is_rebin_step(int(d.step_count), params)
    f = step_passes(params)
    with span("sph.step"):
        with span("sph.fluid.density"):
            rho, prs, pr2 = f.tail(
                f.density(d.px, d.py, d.pz, d.occ, params, spec), d.occ,
                params)
        d = d.replace_fields(rho=rho, prs=prs)
        with span("sph.fluid.accel"):
            ax, ay, az = f.accel(d, pr2, params, spec)
        with span("sph.fluid.integrate"):
            px, py, pz, vx, vy, vz, n_clamped, n_pushed = f.integrate(
                d, ax, ay, az, params, rebin_vmax(params, spec), drag=drag
            )
        if rebin_now:
            with span("sph.fluid.rebin"):
                d = f.rebin(d, px, py, pz, vx, vy, vz, params, spec)
        else:
            d = d.replace_fields(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz)
        obstacle_pushed(px.device).add_(n_pushed)
        return d.replace_fields(
            step_count=d.step_count + 1, clamped=d.clamped + n_clamped
        )


def _check_rebin_cadence(params: SPHParams, spec: DenseSpec):
    if params.rebin_every > 1 and spec.cell <= params.h * 1.01:
        raise ValueError(
            "rebin_every > 1 needs cell_factor > 1 (stencil drift margin is "
            f"(cell - h)/2 = {(spec.cell - params.h) / 2:.2e})"
        )


def make_dense_step(params: SPHParams, spec: DenseSpec, substeps: int = 1):
    """(state, step, drag=None) -> state after `substeps` steps, where
    `step` is the host's mirror of `state.step_count`: the rebin cadence is
    decided from it, so the loop never waits for the device."""
    _check_rebin_cadence(params, spec)

    def f(st: DenseFluidState, step: int, drag=None) -> DenseFluidState:
        for i in range(substeps):
            st = dense_step(st, params, spec, drag=drag,
                            rebin_now=is_rebin_step(step + i, params))
        return st

    return f
