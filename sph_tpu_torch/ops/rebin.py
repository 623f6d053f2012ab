"""Wrapper of the staged-rebin kernel K3, `csrc/rebin_stage.cu` — the
counterpart of `rebin_pallas` / `_run_stage` (sph_tpu/ops/pallas/rebin.py).

A CPU tensor goes to the plain `sph_tpu_torch.sph.dense.rebin`; a CUDA
tensor launches one kernel per stage (in-row cells, rows, planes) or
raises. The final sentinel cleanup is plain torch, as it sits outside the
Pallas kernel in JAX. Bitwise equal to the plain version given identical
inputs (±0 aside: the plain version's masked sums give +0 where the kernel
copies −0).
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_launch,
    check_operands,
    library,
    stream_of,
)
from sph_tpu_torch.sph import dense

NF = 7  # payload: px, py, pz, vx, vy, vz, occ


def rebin_stage(fields, stage: int, spec, dropped: torch.Tensor):
    """Run one stage (layout dim `stage`: 2 in-row, 1 rows, 0 planes) on
    the 7 payload fields; returns 7 fresh tensors and adds the stage's
    casualties to `dropped` (a 1-element int32 CUDA tensor)."""
    dev = fields[0].device
    shape = (spec.n0, spec.k, spec.C)
    check_operands("rebin_stage", fields, shape, dev)
    if (dropped.device != dev or dropped.dtype != torch.int32
            or dropped.numel() != 1):
        raise ValueError("rebin_stage: dropped must be one int32 on "
                         f"{dev}")
    lib = library().lib
    axis = spec.axis_map[stage]
    n_cells = spec.world_cells()[axis]
    lo = min(1, n_cells - 1)
    hi = max(n_cells - 2, lo)
    outs = [torch.empty_like(fields[0]) for _ in range(NF)]
    ins_p = (ctypes.c_void_p * NF)(*(f.data_ptr() for f in fields))
    outs_p = (ctypes.c_void_p * NF)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        rc = lib.sph_rebin_stage(
            ins_p, outs_p, dropped.data_ptr(), spec.n0, spec.k, spec.C,
            spec.X, stage, axis, float(spec.origin[axis]), float(spec.cell),
            lo, hi, stream_of(dev),
        )
    check_launch("rebin_stage", rc)
    LAUNCHES["rebin_stage"] += 1
    return outs


def staged_rebin(d, px, py, pz, vx, vy, vz, params, spec):
    """Drop-in for sph_tpu_torch.sph.dense.rebin (its plain version)."""
    if px.device.type == "cpu":
        return dense.rebin(d, px, py, pz, vx, vy, vz, params, spec)
    fields = [px, py, pz, vx, vy, vz, d.occ]
    dropped = torch.zeros(1, dtype=torch.int32, device=px.device)
    for stage in dense.rebin_stages(spec):
        fields = rebin_stage(fields, stage, spec, dropped)
    return dense.finish_rebin(d, fields, dropped[0])
