"""Wrapper of the colony contact sweep kernel K4, `csrc/contact_sweep.cu`
— the counterpart of `contact_sweep_pallas` (sph_tpu/ops/pallas/
contact.py) — and the kernel's band planner.

A CPU tensor goes to the plain `_sweep_plain`
(sph_tpu_torch.physics.contact_dense); a CUDA tensor launches the kernel or
raises — there is no fallback. On the card the kernel equals the plain
version bitwise (same terms, same order, no FMA), with +0 on empty slots;
the contract it is held to is the JAX twin's, rtol 1e-5 and atol
1e-6·max|x| on every slot. Outputs are allocated here with one
torch.empty (the kernel writes every slot; the six planes are views of
it); the kernel launches on PyTorch's current stream, once a call, and is
not synchronised. Its band cursor, two int32 counters the kernel leaves
zeroed, is kept here per (device, stream) and made at the stream's first
launch; A2's finishing launch (ops/adhesion.py `bond_scan`) takes its
tickets from the same counters and leaves them zeroed too.
"""

from __future__ import annotations

import ctypes
import functools
import threading
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
from sph_tpu_torch.ops.fluid import SMEM_LIMIT

NCOMP = 6  # force[3], torque[3]
THREADS = 256                   # kThreads in csrc/contact_sweep.cu
TAIL = 32                       # kTail: the mbarriers and the claim slot
BAND_ROWS = 5                   # rows a band (tools/probe_contact_plans.py)
SLOT_COUNTS = (1, 2, 4)         # the K the kernel is built for
CURSOR_INTS = 2                 # the band cursor: next band, blocks done


@dataclass(frozen=True)
class BandPlan:
    """One band = `rows` whole rows of one plane; a sweep block holds the
    occupancy of the band and of the next one (two buffers of rows·L
    floats) and lists the band's occupied slots from its masks, in
    `smem_bytes` of dynamic shared memory (csrc/contact_sweep.cu
    `smem_bytes_of`); the screen reads the partners' positions and radii
    through L1, nothing is staged."""

    rows: int          # rows a band holds (the last band may be shorter)
    bands: int         # bands per plane
    smem_bytes: int


def _plan(spec, rows: int) -> BandPlan:
    own = rows * spec.L        # the occupancy buffers, list and masks
    smem = 4 * (3 * own + own // 32 + THREADS // 32) + TAIL
    return BandPlan(rows=rows, bands=-(-spec.ny // rows), smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def band_plan(spec) -> BandPlan:
    """Bands of BAND_ROWS rows (the plane's Y if fewer); raises when that
    does not fit in a block's shared memory, or the kernel is not built for
    the spec's K."""
    if spec.k not in SLOT_COUNTS:
        raise ValueError(f"the contact sweep kernel is built for K in "
                         f"{SLOT_COUNTS}, not K={spec.k}")
    if spec.L % 32:
        raise ValueError(f"lane axis {spec.L} is not a multiple of 32: the "
                         f"gate needs whole 32-slot masks")
    plan = _plan(spec, min(BAND_ROWS, spec.ny))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"a band of {plan.rows} rows needs {plan.smem_bytes} bytes of "
            f"shared memory, more than the {SMEM_LIMIT} a block has "
            f"(L={spec.L}, K={spec.k})")
    return plan


def plan_of(spec, rows: int | None = None) -> BandPlan:
    """`band_plan(spec)`, or the plan of bands of `rows` rows when given
    (the design probes force band heights)."""
    return band_plan(spec) if rows is None else _plan(spec, rows)


_CURSORS: dict = {}   # (device, stream handle) -> the stream's band cursor
_ARGS = threading.local()   # each thread's ctypes pointer arrays


def launch_on_cursor(name: str, dev, stream: int, launch) -> None:
    """launch(cursor pointer) → cudaError_t, with the band cursor of
    `stream` on `dev`: CURSOR_INTS zeroed int32, made at the stream's first
    launch and left zeroed by every launch that runs (calls on one stream
    run in order, so K4 and A2 share it). A launch that fails drops the
    cursor (a call that did not run to its end may leave counts in it),
    then raises."""
    key = (dev, stream)
    cursor = _CURSORS.get(key)
    if cursor is None:
        cursor = _CURSORS[key] = torch.zeros(CURSOR_INTS, dtype=torch.int32,
                                             device=dev)
    rc = launch(cursor.data_ptr())
    if rc != 0:
        _CURSORS.pop(key, None)
        check_launch(name, rc)


# The band sweep's stage modes and their codes (`Mode` in the .cu): the
# floor modes of ops/contact_floor.py, then the production sweep.
MODE_CODES = {"zero": 0, "pads": 1, "screen": 2, "full": 3}


def resident_blocks(spec, mode: str, plan: BandPlan, dev) -> int:
    """Sweep blocks of `mode` (K4 is "full"; the floor modes' names) that
    the occupancy API puts on one SM of CUDA device `dev` at `plan`: the
    persistent grid a launch sizes, over the SM count."""
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        check_launch("contact_grid", library().lib.sph_contact_grid(
            spec.nz, spec.ny, spec.L, spec.k, plan.rows, plan.smem_bytes,
            MODE_CODES[mode], dev.index, ctypes.byref(grid)))
    return grid.value // torch.cuda.get_device_properties(
        dev).multi_processor_count


def contact_sweep(fields, occ, params, spec, rows: int | None = None):
    """Own-side force and torque per slot: 6 [Z, Y, L] planes. `fields`
    are the 10 packed planes (px, py, pz, vx, vy, vz, ox, oy, oz, rad),
    `occ` the occupancy plane. Z is the operands' own plane count: a
    sharded step passes halo-padded slabs of P + 2 planes (and, over a 2D
    mesh, a spec of its local rows); `spec` gives Y, L and K. `rows`
    forces the band height (`plan_of`)."""
    if fields[0].device.type == "cpu":
        from sph_tpu_torch.physics import contact_dense as cd

        return cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(params, *a), NCOMP,
            spec)
    outs = launch_bands(
        "contact_sweep", library().lib.sph_contact_sweep, fields, occ, spec,
        plan_of(spec, rows), params.contact_epsilon,
        params.slip_epsilon, params.repulsion_strength, params.torque_factor,
        params.rolling_contact_radius_multiplier)
    LAUNCHES["contact"] += 1
    return outs


def launch_bands(name, entry, fields, occ, spec, plan: BandPlan, *model):
    """Check the operands and call a band-sweep entry point of
    csrc/contact_sweep.cu (`sph_contact_sweep`, `sph_contact_floor`) with
    the pointers, the cursor, the geometry, `plan`, then `model`, the
    device and the stream; returns its 6 output planes (views of one
    torch.empty: the kernel writes every slot)."""
    dev = occ.device
    check_device(name, (*fields, occ), dev)
    if len(fields) != 10:
        raise ValueError(f"{name}: expected 10 fields, got {len(fields)}")
    nz = slab_planes(name, (*fields, occ), (spec.ny, spec.L))
    if occ.numel() >= 1 << 31:
        raise ValueError(f"{name}: {occ.numel()} slots; the kernel's "
                         f"stencil indices are 32-bit (fewer than 2^31)")
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: a band of {plan.rows} rows needs "
                         f"{plan.smem_bytes} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block has")
    out = torch.empty((NCOMP, *occ.shape), dtype=torch.float32, device=dev)
    outs = list(out.unbind(0))
    args = getattr(_ARGS, "arrays", None)
    if args is None:
        args = _ARGS.arrays = ((ctypes.c_void_p * 10)(),
                               (ctypes.c_void_p * NCOMP)())
    ins_p, outs_p = args
    ins_p[:] = [f.data_ptr() for f in fields]
    outs_p[:] = [o.data_ptr() for o in outs]
    stream = stream_of(dev)
    with torch.cuda.device(dev):
        launch_on_cursor(name, dev, stream, lambda cursor: entry(
            ins_p, occ.data_ptr(), outs_p, cursor, nz, spec.ny, spec.L,
            spec.k, plan.rows, plan.smem_bytes, *model, dev.index, stream))
    return outs
