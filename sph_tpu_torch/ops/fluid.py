"""Wrappers of the dense-step pair-sweep kernels K1 (density) and K2
(pressure + viscosity acceleration), `csrc/fluid_sweep.cu` — the
counterparts of `density_pallas` / `accel_pallas`
(sph_tpu/ops/pallas/fluid.py) — and the kernels' tile planner.

A CPU tensor goes to the plain version (sph_tpu_torch.sph.dense); a CUDA
tensor launches the kernel or raises — there is no fallback. Outputs are
allocated here with torch.empty (the kernel writes every slot: its sum on
occupied ones, +0 on empty ones); kernels launch on PyTorch's current
stream and are not synchronised. `sweep_screens` counts, in plain torch
and outside the step, the partner slots their walk screens at an
occupancy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_launch,
    check_device,
    library,
    slab_planes,
    stream_of,
)
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph import kernels as KN

SMEM_LIMIT = 232_448            # dynamic shared memory of one block, sm_90
SMEM_TARGET = 233_472 // 2 - 1_024   # two resident blocks per SM (each
                                     # also takes 1 KB the system reserves)
MAX_BAND_ROWS = 8
THREADS = 512                   # kThreads in csrc/fluid_sweep.cu
PAD = 4                         # kPad: floats staged past each band end
LOADS = 4                       # kLoads: occupancy loads per thread
SLOT_COUNTS = (4, 8, 16)        # the K the kernels are built for
R2_CUT_MARGIN = 2.0 ** -16      # K2's r² pre-screen margin over h²


def blocks_per_sm(k: int) -> int:
    """kMinBlocks in csrc/fluid_sweep.cu: the resident sweep blocks an SM
    the build is made for (two up to K = 8, one at K = 16)."""
    return 1 if k > 8 else 2


def extent_walk(k: int) -> bool:
    """kExtentWalk in csrc/fluid_sweep.cu: whether the build's walk stops
    at each partner cell's occupied extent (one block an SM, K = 16) or
    visits every slot (two blocks an SM)."""
    return blocks_per_sm(k) == 1


def partners(spec: dense.DenseSpec) -> int:
    """Partners an own slot visits: the 3×3(×3) cells' slots but itself."""
    return 9 * (1 + 2 * int(spec.stencil0)) * spec.k - 1


@dataclass(frozen=True)
class BandPlan:
    """One band = `rows` whole rows of one plane; a sweep block stages, per
    band, the three position fields of `planes` planes, all K slots and the
    fused run [(r0 − 1)·X − PAD, (r0 + rows + 1)·X + PAD) of each (and,
    for the extent walk, those cells' extents, a byte each), and keeps a
    table of its partners, in `smem_bytes` of dynamic shared memory
    (csrc/fluid_sweep.cu `Layout`)."""

    rows: int          # rows a band holds (the last band may be shorter)
    bands: int         # bands per plane
    planes: int        # staged planes: z − 1, z, z + 1, or z alone
    run: int           # staged floats per (field, plane, slot)
    smem_bytes: int


def _plan(spec: dense.DenseSpec, rows: int) -> BandPlan:
    planes = 1 + 2 * int(spec.stencil0)
    run = (rows + 2) * spec.X + 2 * PAD
    smem = (16 * partners(spec)
            + 4 * (3 * planes * spec.k * run + spec.k * rows * spec.X
                   + LOADS * (THREADS // 32)) + 16
            + (planes * run if extent_walk(spec.k) else 0))
    return BandPlan(rows=rows, bands=-(-spec.n1 // rows), planes=planes,
                    run=run, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def band_plan(spec: dense.DenseSpec) -> BandPlan:
    """The most rows per band (up to MAX_BAND_ROWS) that keep the build's
    sweep blocks resident on an SM (two up to K = 8, one at K = 16); one
    row if even that needs more; raises when one row does not fit in a
    block's shared memory, or the kernels are not built for the spec."""
    if spec.k not in SLOT_COUNTS or not spec.stencil1:
        raise ValueError(f"the sweep kernels are built for K in "
                         f"{SLOT_COUNTS} with a row stencil, not K={spec.k}"
                         f", stencil1={spec.stencil1}")
    if spec.X % PAD:
        raise ValueError(f"row length {spec.X} is not a multiple of {PAD}: "
                         f"the staging copies need 16-byte runs")
    plans = [_plan(spec, r) for r in range(1, min(MAX_BAND_ROWS, spec.n1) + 1)]
    target = SMEM_TARGET if blocks_per_sm(spec.k) == 2 else SMEM_LIMIT
    fits = [p for p in plans if p.smem_bytes <= target]
    plan = fits[-1] if fits else plans[0]
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"a band of one row needs {plan.smem_bytes} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block has (X={spec.X}, "
            f"K={spec.k}, {plan.planes} planes)")
    return plan


def accel_r2_cut(h: float) -> float:
    """K2's first-pass cut: the least f32 ≥ h²·(1 + 2⁻¹⁶) for h as f32.
    rsqrtf errs by at most 2 ulp (relative 2⁻²²) and the product r²·rsqrt
    rounds once more (2⁻²⁴), so for a finite r² above the cut the kernel's
    r ≥ √r²·(1 − 2⁻²¹) > h·(1 + 2⁻¹⁷)(1 − 2⁻²¹) > h, and h − r ≤ 0: the
    pair is an exact ±0 that the exact screen would drop as well."""
    want = float(np.float32(h)) ** 2 * (1.0 + R2_CUT_MARGIN)
    cut = np.float32(want)
    if float(cut) < want:
        cut = np.nextafter(cut, np.float32(np.inf))
    return float(cut)


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX rounds its weak-typed scalars
    (ctypes.c_float rounds the same way)."""
    return float(np.float32(x))


def _geometry(name: str, tensors, spec: dense.DenseSpec) -> tuple:
    """Checks the operands; returns the kernels' scratch, which the caller
    holds until the launch — the zeroed int32 work list (a count, a cursor,
    one entry per band) and, for the extent walk, the uint8 [n0, C] plane
    of each cell's occupied extent, which the gate fills — and their
    pointers and geometry arguments. The plane count is the
    operands' own, as the Pallas kernel takes it from its array: a
    sharded step passes halo-padded slabs of P + 2 planes (and, over a 2D
    mesh, the spec of its local rows); `spec` gives the rest."""
    check_device(name, tensors, tensors[0].device)
    n0 = slab_planes(name, tensors, (spec.k, spec.C))
    plan = band_plan(spec)
    work = torch.zeros(2 + n0 * plan.bands, dtype=torch.int32,
                       device=tensors[0].device)
    ext = torch.empty((n0, spec.C) if extent_walk(spec.k) else 0,
                      dtype=torch.uint8, device=tensors[0].device)
    return (work, ext), (work.data_ptr(), ext.data_ptr(), n0, spec.k,
                         spec.C, spec.X, int(spec.stencil0),
                         int(spec.stencil1), plan.rows, plan.smem_bytes)


def density_sweep(px, py, pz, occ, params, spec) -> torch.Tensor:
    """Scaled raw ρ over every slot (caller applies the occupancy fixup);
    the kernel gives +0 on empty slots and, on occupied ones, the bits of
    the plain dense.density_raw."""
    if px.device.type == "cpu":
        return dense.density_raw(px, py, pz, params, spec)
    scratch, geom = _geometry("density_sweep", (px, py, pz, occ), spec)
    lib = library().lib
    out = torch.empty_like(px)
    scale = params.particle_mass * KN.poly6_coeff(params.h, params.ndim)
    with torch.cuda.device(px.device):
        rc = lib.sph_density_sweep(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), occ.data_ptr(),
            out.data_ptr(), *geom,
            _f32(params.h * params.h), dense.density_self_term(params),
            _f32(scale), stream_of(px.device),
        )
    check_launch("density_sweep", rc)
    LAUNCHES["density"] += 1
    return out


def accel_sweep(d, pr2, params, spec):
    """Pressure + viscosity acceleration (no gravity/obstacles here); the
    kernel gives +0 on empty slots and, on occupied ones, the bits of the
    plain dense.accel_raw on 1/ρ = torch.reciprocal(ρ) (the kernel takes
    ρ and forms the same correctly rounded 1/ρ itself)."""
    if d.px.device.type == "cpu":
        return dense.accel_raw(d, torch.reciprocal(d.rho), pr2, params, spec)
    ins = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, d.rho, pr2, d.occ)
    scratch, geom = _geometry("accel_sweep", ins, spec)
    lib = library().lib
    outs = [torch.empty_like(d.px) for _ in range(3)]
    h, neg_m_spiky, visc_mc = dense.accel_constants(params)
    with torch.cuda.device(d.px.device):
        rc = lib.sph_accel_sweep(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            *geom, _f32(h), _f32(neg_m_spiky), _f32(visc_mc),
            accel_r2_cut(h), stream_of(d.px.device),
        )
    check_launch("accel_sweep", rc)
    LAUNCHES["accel"] += 1
    return tuple(outs)


@dataclass(frozen=True)
class Screens:
    """The partner slots the sweeps' walk screens at one occupancy
    (`sweep_screens`), summed over the occupied own slots, a lane at a time
    and a warp at a time, beside the full stencil's counts."""

    occupied: int      # own slots walked
    warps: int         # warp walks: 32 consecutive slots of a band's list
    partners: int      # the full stencil's partners an own slot: 27·K − 1
    lane: int          # partner slots below their cell's extent
    warp: int          # partner slots the warps walk

    @property
    def lane_share(self) -> float:
        return self.lane / max(self.partners * self.occupied, 1)

    @property
    def warp_share(self) -> float:
        return self.warp / max(self.partners * self.warps, 1)


def extents(occ: torch.Tensor) -> torch.Tensor:
    """Each cell's occupied extent, 1 + its highest occupied slot (0 when
    empty), as int32 [n0, C]: what the gate kernel writes."""
    slots = torch.arange(1, occ.shape[1] + 1, dtype=torch.int32,
                         device=occ.device)
    return ((occ > 0.5) * slots[:, None]).amax(dim=1).to(torch.int32)


def sweep_screens(occ: torch.Tensor, spec: dense.DenseSpec) -> Screens:
    """What K1's and K2's walk screens at occupancy `occ` [n0, K, C], in
    plain torch on its device; it reads its counts back to the host, so
    the step never calls it. An own slot needs, of each of its 27 (9 in
    2D) partner cells, the slots below that cell's extent, itself left out:
    Σ extents − 1 of the full stencil's 27·K − 1 (`lane`). The walk gives
    each warp 32 consecutive own slots of a band's list (slot-major, then
    cell; the bands of `band_plan`). The extent walk (`extent_walk`) has a
    warp screen the own cell's K − 1 partners and, of each other cell, as
    many slots as the largest extent among its lanes; the full walk, every
    partner (`warp`). Counted by occupancy: an own slot whose position is
    not finite walks every partner."""
    k, x, c_len = spec.k, spec.X, spec.C
    n0 = occ.shape[0]
    s0 = int(spec.stencil0)
    plan = band_plan(spec)
    dev = occ.device
    # Extents with a zero border: a partner cell beyond the array is empty.
    ext = torch.nn.functional.pad(extents(occ), (x + 1, x + 1, s0, s0))
    z, slot, c = torch.nonzero(occ > 0.5, as_tuple=True)
    n = int(z.numel())
    band = z * plan.bands + torch.div(c, x * plan.rows, rounding_mode="floor")
    order = torch.argsort((band * k + slot) * c_len + c)
    z, c, band = z[order], c[order], band[order]
    counts = torch.bincount(band, minlength=n0 * plan.bands)
    warps = torch.div(counts + 31, 32, rounding_mode="floor")
    rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[band]
    at = (torch.cumsum(warps, 0) - warps)[band] * 32 + rank
    n_warps = int(warps.sum())
    walk = extent_walk(k)
    lane = 0
    warp = n_warps * ((k - 1) if walk else partners(spec))
    for dz in range(-s0, s0 + 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                e = ext[z + s0 + dz, c + x + 1 + dy * x + dx]
                lane += int(e.sum())
                if not walk or dz == dy == dx == 0:
                    continue
                most = torch.zeros(n_warps * 32, dtype=e.dtype, device=dev)
                most[at] = e
                warp += int(most.view(n_warps, 32).amax(dim=1).sum())
    return Screens(occupied=n, warps=n_warps, partners=partners(spec),
                   lane=lane - n, warp=warp)
