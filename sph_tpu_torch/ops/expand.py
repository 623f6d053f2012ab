"""Wrapper of the contact pack's placement kernel K5,
`csrc/expand_rows.cu` — the counterpart of `expand_rows`
(sph_tpu/ops/pallas/expand.py).

A CPU tensor goes to the plain `_scatter_sorted`
(sph_tpu_torch.physics.contact_dense); a CUDA tensor launches the kernel or
raises — there is no fallback. Both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import check_launch, library, stream_of


def expand_rows(rows, flat, fits, fills, spec) -> torch.Tensor:
    """Place sorted rows [N, C] f32 at their ascending unique slot targets
    `flat` [N] int32 (`spec.slots` = not placed; `fits` is flat < slots);
    every other slot of column c holds fills[c]. Returns [C, spec.slots]."""
    from sph_tpu_torch.physics.contact_dense import _scatter_sorted

    slots = spec.slots
    if rows.device.type == "cpu":
        planes = _scatter_sorted(rows.unbind(1), fills, flat, fits, spec)
        return torch.stack([p.reshape(-1) for p in planes])
    n, ncol = rows.shape
    dev = rows.device
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError("expand_rows: rows must be contiguous float32")
    if (flat.device != dev or flat.dtype != torch.int32
            or tuple(flat.shape) != (n,) or not flat.is_contiguous()):
        raise ValueError(f"expand_rows: flat must be contiguous int32 [{n}] "
                         f"on {dev}")
    if len(fills) != ncol:
        raise ValueError(f"expand_rows: {len(fills)} fills for {ncol} "
                         f"columns")
    if ncol * slots >= 2 ** 31:
        raise ValueError("expand_rows: output too large for 32-bit slots")
    out = torch.empty((ncol, slots), dtype=torch.float32, device=dev)
    fills_c = (ctypes.c_float * ncol)(*fills)
    with torch.cuda.device(dev):
        rc = library().lib.sph_expand_rows(
            rows.data_ptr(), flat.data_ptr(), out.data_ptr(), n, ncol, slots,
            fills_c, stream_of(dev))
    check_launch("expand_rows", rc)
    LAUNCHES["expand"] += 1
    return out
