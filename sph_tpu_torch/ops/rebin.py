"""Wrapper of the rebin kernel K3, `csrc/rebin.cu` — the counterpart of
`rebin_pallas` (sph_tpu/ops/pallas/rebin.py): its three `_stage_kernel`
launches and the sentinel cleanup after them.

A CPU tensor goes to the plain `sph_tpu_torch.sph.dense.rebin`; any other
tensor launches the kernel's two passes (move codes, then placement) or
raises. Each particle's ρ and p move with it. Bitwise equal to the plain
version given identical inputs (±0 aside: the plain version's masked sums
give +0 where the kernel copies −0), `dropped` included; both raise the device's demand peak
(`ops.rebin_peak`) to the same value.
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch.ops import LAUNCHES, rebin_peak
from sph_tpu_torch.ops.build import (
    check_launch,
    check_operands,
    library,
    stream_of,
)
from sph_tpu_torch.ops.fluid import SMEM_LIMIT
from sph_tpu_torch.sph import dense

NF = 9  # out: px, py, pz, vx, vy, vz, rho, prs, occ
KS = (4, 8, 16)     # the slot counts the kernel is built for
THREADS = 256       # fused cells per placement block (csrc/rebin.cu)


def halo_bytes(spec) -> int:
    """Shared memory of one placement block: its code halo, one K-byte word
    per cell over planes z±1 (one plane without a plane stage) and fused
    offsets ±(X + 1) around its THREADS cells."""
    planes = 3 if spec.stencil0 else 1
    return planes * (THREADS + 2 * (spec.X + 1)) * spec.k


def check_spec(spec) -> None:
    """Raise ValueError for a spec the kernel is not built for."""
    if spec.k not in KS:
        raise ValueError(f"rebin: the kernel is built for K in {KS}, not "
                         f"K = {spec.k}")
    if not spec.stencil1:
        raise ValueError("rebin: the kernel needs a row stage (stencil1)")
    if halo_bytes(spec) > SMEM_LIMIT:
        raise ValueError(f"rebin: a row of {spec.X} cells needs a "
                         f"{halo_bytes(spec)}-byte code halo, more shared "
                         f"memory than a block has")


def staged_rebin(d, px, py, pz, vx, vy, vz, params, spec):
    """Drop-in for sph_tpu_torch.sph.dense.rebin (its plain version)."""
    if px.device.type == "cpu":
        return dense.rebin(d, px, py, pz, vx, vy, vz, params, spec)
    check_spec(spec)
    dev = px.device
    fields = [px, py, pz, vx, vy, vz, d.rho, d.prs, d.occ]
    check_operands("rebin", fields, (spec.n0, spec.k, spec.C), dev)
    if (d.dropped.device != dev or d.dropped.dtype != torch.int32
            or d.dropped.numel() != 1):
        raise ValueError(f"rebin: the state's dropped must be one int32 on "
                         f"{dev}")
    lib = library().lib
    outs = [torch.empty_like(px) for _ in range(NF)]
    codes = torch.empty(spec.n0 * spec.C * spec.k, dtype=torch.uint8,
                        device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    planes = int(spec.stencil0)
    with torch.cuda.device(dev):
        stream = stream_of(dev)
        rc = lib.sph_rebin_codes(
            *(fields[a].data_ptr() for a in spec.axis_map),
            d.occ.data_ptr(), codes.data_ptr(), d.dropped.data_ptr(),
            dropped.data_ptr(), spec.n0, spec.k, spec.C, spec.X, planes,
            *(float(spec.origin[a]) for a in spec.axis_map),
            float(spec.cell), stream)
        check_launch("rebin codes", rc)
        LAUNCHES["rebin"] += 1
        rc = lib.sph_rebin_place(
            (ctypes.c_void_p * 8)(*(f.data_ptr() for f in fields[:8])),
            (ctypes.c_void_p * NF)(*(o.data_ptr() for o in outs)),
            codes.data_ptr(), dropped.data_ptr(), rebin_peak(dev).data_ptr(),
            spec.n0, spec.k, spec.C, spec.X, planes,
            float(params.rest_density), stream)
        check_launch("rebin placement", rc)
        LAUNCHES["rebin"] += 1
    pxn, pyn, pzn, vxn, vyn, vzn, rhon, prsn, occn = outs
    return d.replace_fields(px=pxn, py=pyn, pz=pzn, vx=vxn, vy=vyn, vz=vzn,
                            rho=rhon, prs=prsn, occ=occn, dropped=dropped)
