"""Wrappers of the dense-step pair-sweep kernels K1 (density) and K2
(pressure + viscosity acceleration), `csrc/fluid_sweep.cu` — the
counterparts of `density_pallas` / `accel_pallas`
(sph_tpu/ops/pallas/fluid.py) — and the kernels' tile planner.

A CPU tensor goes to the plain version (sph_tpu_torch.sph.dense); a CUDA
tensor launches the kernel or raises — there is no fallback. Outputs are
allocated here with torch.empty (the kernel writes every slot: its sum on
occupied ones, +0 on empty ones); kernels launch on PyTorch's current
stream and are not synchronised.
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


def partners(spec: dense.DenseSpec) -> int:
    """Partners an own slot visits: the 3×3(×3) cells' slots but itself."""
    return 9 * (1 + 2 * int(spec.stencil0)) * spec.k - 1


@dataclass(frozen=True)
class BandPlan:
    """One band = `rows` whole rows of one plane; a sweep block stages, per
    band, the three position fields of `planes` planes, all K slots and the
    fused run [(r0 − 1)·X − PAD, (r0 + rows + 1)·X + PAD) of each, and
    keeps a table of its partners, in `smem_bytes` of dynamic shared
    memory (csrc/fluid_sweep.cu `Layout`)."""

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
                   + LOADS * (THREADS // 32)) + 16)
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
    """Checks the operands; returns the kernels' zeroed int32 work list
    (a count, a cursor, one entry per band), which the caller holds until
    the launch, and their geometry arguments. The plane count is the
    operands' own, as the Pallas kernel takes it from its array: a
    sharded step passes halo-padded slabs of P + 2 planes (and, over a 2D
    mesh, the spec of its local rows); `spec` gives the rest."""
    check_device(name, tensors, tensors[0].device)
    n0 = slab_planes(name, tensors, (spec.k, spec.C))
    plan = band_plan(spec)
    work = torch.zeros(2 + n0 * plan.bands, dtype=torch.int32,
                       device=tensors[0].device)
    return work, (work.data_ptr(), n0, spec.k, spec.C, spec.X,
                  int(spec.stencil0), int(spec.stencil1), plan.rows,
                  plan.smem_bytes)


def density_sweep(px, py, pz, occ, params, spec) -> torch.Tensor:
    """Scaled raw ρ over every slot (caller applies the occupancy fixup);
    the kernel gives +0 on empty slots and, on occupied ones, the bits of
    the plain dense.density_raw."""
    if px.device.type == "cpu":
        return dense.density_raw(px, py, pz, params, spec)
    work, geom = _geometry("density_sweep", (px, py, pz, occ), spec)
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
    work, geom = _geometry("accel_sweep", ins, spec)
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
