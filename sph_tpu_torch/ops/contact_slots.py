"""Wrappers of the contact pass's slot bookkeeping, `csrc/contact_slots.cu`.
The JAX package has no Pallas kernel here: XLA fuses this code inside its
jitted step (sph_tpu/physics/contact_dense.py `_rank_and_slots`,
`gather_back`).

- `rank_and_slots`: after the pack sort, each sorted row's rank in its
  cell, the rows that fit, their slots, the placement keys K5 reads, the
  overflow and the particle-order `slot_of`, in one launch.
- `gather_back`: after K4, the six per-slot components read back to
  particle order at `slot_of`, in one launch.

A CPU tensor goes to the plain version (sph_tpu_torch.physics.contact_dense
`_rank_and_slots`, `gather_back`); a CUDA tensor launches the kernel, or
raises — there is no fallback. The operands are checked on both routes.
Outputs are fresh (torch.empty: the kernels write every element); the
kernels launch on PyTorch's current stream and are not synchronised, and a
call makes no host read.
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_device,
    check_launch,
    check_layout,
    library,
    stream_of,
)
from sph_tpu_torch.ops.contact import NCOMP, launch_on_cursor
from sph_tpu_torch.physics import contact_dense as cd


def _int_vector(name: str, what: str, t, n: int, dtype) -> None:
    if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name}: expected {what} as a contiguous {dtype} "
                         f"of shape ({n},), got {t.dtype} {tuple(t.shape)}")


def _same_device(name: str, tensors, dev) -> None:
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: expected every operand on {dev}, got "
                             f"{t.device}")


def rank_and_slots(cid_s, order, spec):
    """Drop-in for contact_dense._rank_and_slots: (flat, fits, key,
    overflow, slot_of) of the sorted cell ids `cid_s` [N] int32 and the
    sort's permutation `order` [N] int64."""
    name = "contact_slots"
    if cid_s.dim() != 1:
        raise ValueError(f"{name}: expected the sorted cell ids as a vector, "
                         f"got shape {tuple(cid_s.shape)}")
    n = cid_s.shape[0]
    _int_vector(name, "the sorted cell ids", cid_s, n, torch.int32)
    _int_vector(name, "the sort's order", order, n, torch.int64)
    if spec.k < 1 or spec.slots >= 2 ** 31 or n >= 2 ** 30:
        raise ValueError(f"{name}: {spec.slots} slots (K={spec.k}) and {n} "
                         f"rows overflow the kernel's 32-bit indexing")
    dev = cid_s.device
    if dev.type == "cpu":
        _same_device(name, (order,), dev)
        return cd._rank_and_slots(cid_s, order, spec)
    check_device(name, (cid_s, order), dev)
    dead = spec.nz * spec.ny * spec.nx_pad
    ints = torch.empty((3, n), dtype=torch.int32, device=dev)
    flat, key, slot_of = ints.unbind(0)
    fits = torch.empty((n,), dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    stream = stream_of(dev)
    with torch.cuda.device(dev):
        launch_on_cursor(name, dev, stream, lambda cursor: (
            library().lib.sph_contact_slots(
                cid_s.data_ptr(), order.data_ptr(), n, spec.k, dead,
                spec.slots, flat.data_ptr(), fits.data_ptr(), key.data_ptr(),
                slot_of.data_ptr(), overflow.data_ptr(), cursor, dev.index,
                stream)))
    LAUNCHES[name] += 1
    return flat, fits, key, overflow, slot_of


def gather_back(comps_flat, slot_of, overflow):
    """Drop-in for contact_dense.gather_back: (force [N, 3], torque [N, 3],
    overflow) of the six per-slot components `comps_flat` (each [slots]
    f32) at `slot_of` [N] int32; a particle whose slot_of is `slots` (it
    did not fit its cell) gets the clamped slot's values times 0."""
    name = "contact_gather"
    if len(comps_flat) != NCOMP:
        raise ValueError(f"{name}: expected {NCOMP} component planes, got "
                         f"{len(comps_flat)}")
    slots = comps_flat[0].numel()
    check_layout(name, comps_flat, (slots,))
    if slots < 1:
        raise ValueError(f"{name}: expected at least one slot")
    if slot_of.dim() != 1:
        raise ValueError(f"{name}: expected slot_of as a vector, got shape "
                         f"{tuple(slot_of.shape)}")
    n = slot_of.shape[0]
    _int_vector(name, "slot_of", slot_of, n, torch.int32)
    if n * NCOMP >= 2 ** 31:
        raise ValueError(f"{name}: {n} particles overflow the kernel's "
                         f"32-bit indexing")
    dev = slot_of.device
    if dev.type == "cpu":
        _same_device(name, comps_flat, dev)
        return cd.gather_back(comps_flat, slot_of, overflow)
    check_device(name, (*comps_flat, slot_of), dev)
    out = torch.empty((n, NCOMP), dtype=torch.float32, device=dev)
    planes = (ctypes.c_void_p * NCOMP)(*(c.data_ptr() for c in comps_flat))
    with torch.cuda.device(dev):
        rc = library().lib.sph_contact_gather(
            planes, slot_of.data_ptr(), out.data_ptr(), n, slots,
            stream_of(dev))
    check_launch(name, rc)
    LAUNCHES[name] += 1
    return out[:, :3], out[:, 3:], overflow
