"""Wrapper of the contact pack's placement kernel K5,
`csrc/expand_rows.cu` — the counterpart of `expand_rows`
(sph_tpu/ops/pallas/expand.py).

A CPU tensor goes to the plain `_scatter_sorted`
(sph_tpu_torch.physics.contact_dense) on the targets the keys give; a CUDA
tensor launches the kernel, once a call, or raises — there is no fallback.
Both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import check_launch, library, stream_of

RANGE = 512    # slots per range (kRange in csrc/expand_rows.cu)


def expand_rows(rows, key, fills, spec) -> torch.Tensor:
    """Place sorted rows [N, C] f32 at their slots; every other slot of
    column c holds fills[c]. Returns [C, spec.slots]. `key` [N] int32 is
    the pack's nondecreasing key (`_rank_and_slots`): a row goes to slot
    `key` when it fits, i.e. when its key is below `spec.slots` and differs
    from the key of the row before (`targets_of_keys`)."""
    slots = spec.slots
    if rows.device.type == "cpu":
        from sph_tpu_torch.physics.contact_dense import (
            _scatter_sorted,
            targets_of_keys,
        )

        flat, fits = targets_of_keys(key, slots)
        planes = _scatter_sorted(rows.unbind(1), fills, flat, fits, spec)
        return torch.stack([p.reshape(-1) for p in planes])
    n, ncol = rows.shape
    dev = rows.device
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError("expand_rows: rows must be contiguous float32")
    if (key.device != dev or key.dtype != torch.int32
            or tuple(key.shape) != (n,) or not key.is_contiguous()):
        raise ValueError(f"expand_rows: key must be contiguous int32 [{n}] "
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
            rows.data_ptr(), key.data_ptr(), out.data_ptr(), n, ncol, slots,
            fills_c, dev.index, stream_of(dev))
    check_launch("expand_rows", rc)
    LAUNCHES["expand"] += 1
    return out
