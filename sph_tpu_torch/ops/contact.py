"""Wrapper of the colony contact sweep kernel K4, `csrc/contact_sweep.cu`
— the counterpart of `contact_sweep_pallas` (sph_tpu/ops/pallas/
contact.py) — and the kernel's band planner.

A CPU tensor goes to the plain `_sweep_plain`
(sph_tpu_torch.physics.contact_dense); a CUDA tensor launches the kernel or
raises — there is no fallback. On the card the kernel equals the plain
version bitwise (same terms, same order, no FMA), with +0 on empty slots;
the contract it is held to is the JAX twin's, rtol 1e-5 and atol
1e-6·max|x| on every slot. Outputs are allocated here with torch.empty
(the kernel writes every slot); the kernel launches on PyTorch's current
stream and is not synchronised.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_launch,
    check_device,
    library,
    slab_planes,
    stream_of,
)
from sph_tpu_torch.ops.fluid import SMEM_LIMIT, SMEM_TARGET

NCOMP = 6  # force[3], torque[3]
THREADS = 256                   # kThreads in csrc/contact_sweep.cu
STAGED = 4                      # kStaged: px, py, pz, rad
MAX_BAND_ROWS = 8
SLOT_COUNTS = (1, 2, 4)         # the K the kernel is built for


def lane_pad(k: int) -> int:
    """Lanes staged beyond each end of a row: the stencil's lane reach
    P = 2K − 1 rounded up to 4 floats (16 bytes), as `lane_pad` in the
    kernel."""
    return -(-(2 * k - 1) // 4) * 4


@dataclass(frozen=True)
class BandPlan:
    """One band = `rows` whole rows of one plane; a sweep block stages, per
    band, px, py, pz and rad of planes z − 1, z, z + 1 and rows r0 − 1 ..
    r0 + rows, each row `run` = L + 2·lane_pad(K) floats, and lists the
    band's occupied slots, in `smem_bytes` of dynamic shared memory
    (csrc/contact_sweep.cu `smem_bytes_of`)."""

    rows: int          # rows a band holds (the last band may be shorter)
    bands: int         # bands per plane
    run: int           # staged floats per (field, plane, row)
    smem_bytes: int


def _plan(spec, rows: int) -> BandPlan:
    run = spec.L + 2 * lane_pad(spec.k)
    halo = STAGED * 3 * (rows + 2) * run
    smem = 4 * (halo + rows * spec.L + THREADS // 32) + 16
    return BandPlan(rows=rows, bands=-(-spec.ny // rows), run=run,
                    smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def band_plan(spec) -> BandPlan:
    """The most rows per band (up to MAX_BAND_ROWS and the plane's Y) that
    keep two sweep blocks resident on an SM; one row if even that needs
    more; raises when one row does not fit in a block's shared memory, or
    the kernel is not built for the spec's K."""
    if spec.k not in SLOT_COUNTS:
        raise ValueError(f"the contact sweep kernel is built for K in "
                         f"{SLOT_COUNTS}, not K={spec.k}")
    if spec.L % 32 or spec.L < 2 * lane_pad(spec.k):
        raise ValueError(f"lane axis {spec.L} is not a multiple of 32 at "
                         f"least 2·{lane_pad(spec.k)} long: the staging "
                         f"copies need 16-byte runs, the gate whole masks")
    plans = [_plan(spec, r) for r in range(1, min(MAX_BAND_ROWS, spec.ny) + 1)]
    fits = [p for p in plans if p.smem_bytes <= SMEM_TARGET]
    plan = fits[-1] if fits else plans[0]
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"a band of one row needs {plan.smem_bytes} bytes of shared "
            f"memory, more than the {SMEM_LIMIT} a block has (L={spec.L}, "
            f"K={spec.k})")
    return plan


def work_ints(spec, plan: BandPlan, nz: int) -> int:
    """Entries of the kernel's zeroed int32 work buffer for `nz` planes: a
    count, a cursor, the band list and each band's occupancy masks
    (csrc/contact_sweep.cu `Work`)."""
    bands = nz * plan.bands
    return 2 + bands + bands * plan.rows * spec.L // 32


def contact_sweep(fields, occ, params, spec):
    """Own-side force and torque per slot: 6 [Z, Y, L] planes. `fields`
    are the 10 packed planes (px, py, pz, vx, vy, vz, ox, oy, oz, rad),
    `occ` the occupancy plane. Z is the operands' own plane count: a
    sharded step passes halo-padded slabs of P + 2 planes (and, over a 2D
    mesh, a spec of its local rows); `spec` gives Y, L and K."""
    from sph_tpu_torch.physics import contact_dense as cd

    if fields[0].device.type == "cpu":
        return cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(params, *a), NCOMP,
            spec)
    dev = fields[0].device
    check_device("contact_sweep", (*fields, occ), dev)
    if len(fields) != 10:
        raise ValueError(f"contact_sweep: expected 10 fields, got "
                         f"{len(fields)}")
    nz = slab_planes("contact_sweep", (*fields, occ), (spec.ny, spec.L))
    plan = band_plan(spec)
    work = torch.zeros(work_ints(spec, plan, nz), dtype=torch.int32,
                       device=dev)
    outs = [torch.empty_like(occ) for _ in range(NCOMP)]
    ins_p = (ctypes.c_void_p * 10)(*(f.data_ptr() for f in fields))
    outs_p = (ctypes.c_void_p * NCOMP)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        rc = library().lib.sph_contact_sweep(
            ins_p, occ.data_ptr(), outs_p, work.data_ptr(), nz, spec.ny,
            spec.L, spec.k, plan.rows, plan.smem_bytes,
            params.contact_epsilon, params.slip_epsilon,
            params.repulsion_strength, params.torque_factor,
            params.rolling_contact_radius_multiplier, stream_of(dev))
    check_launch("contact_sweep", rc)
    LAUNCHES["contact"] += 1
    return outs
