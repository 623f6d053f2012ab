"""Wrappers of the adhesion pass's kernels, `csrc/adhesion.cu`. The JAX
package has no Pallas kernel here: XLA fuses this code inside its jitted
step.

- A1 `bond_rows`: the endpoint gather, the spring parameters, the spring,
  anchor-swing and relative-orientation deltas of every bond, and the
  [Mp, 7] row table the accumulates read (`bond_spring_params` and
  `bond_pair_deltas`, sph_tpu/physics/adhesion.py). dt reaches the kernel
  as f32, as torch rounds a Python float that meets an f32 tensor; the
  kernel reads the genome's mode count on the device.
- A2 `bond_scan`: the planned accumulate of that table, the row gather in
  the plan's order, the segmented scan in `_blocked_segscan`'s tree and
  each particle's run total (`accumulate_bond_deltas_planned`), in two
  launches of one call.

A CPU tensor goes to the plain version (sph_tpu_torch.physics.adhesion
`bond_rows`, `accumulate_bond_deltas_planned`); a CUDA tensor launches the
kernel, or raises — there is no fallback. Outputs and scratch are fresh
(torch.empty: the kernels write every element read); the kernels launch on
PyTorch's current stream and are not synchronised, and a call makes no
host read.
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
from sph_tpu_torch.ops.contact import launch_on_cursor
from sph_tpu_torch.physics import adhesion


def _int_operands(name: str, tensors, shape, dtype) -> None:
    for t in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")


def bond_rows(state, params, genome, dt=None) -> torch.Tensor:
    """Drop-in for sph_tpu_torch.physics.adhesion.bond_rows: the [Mp, 7]
    row table of the state's bonds (Mp = adhesion.padded_rows(B))."""
    if state.pos.device.type == "cpu":
        return adhesion.bond_rows(state, params, genome, dt)
    b = state.bonds
    n, nb = state.capacity, b.capacity
    dev = state.pos.device
    rows = adhesion.padded_rows(nb)
    tables = (genome.adhesion_rest_length, genome.adhesion_spring_stiffness,
              genome.adhesion_spring_damping,
              genome.orientation_constraint_strength)
    cells = (state.pos, state.vel, state.rot, state.mass)
    bonds = (b.slot_a, b.slot_b, b.active, b.uid_a, b.anchor_a, b.anchor_b,
             b.rel_orientation)
    check_device("bond_rows", (*cells, *bonds, genome.n_modes, *tables), dev)
    if n < 1:
        raise ValueError("bond_rows: expected at least one cell")
    for t, shape in zip(cells, ((n, 3), (n, 3), (n, 4), (n,))):
        check_layout("bond_rows", (t,), shape)
    for t, shape in zip(bonds[4:], ((nb, 3), (nb, 3), (nb, 4))):
        check_layout("bond_rows", (t,), shape)
    _int_operands("bond_rows", (b.slot_a, b.slot_b, b.uid_a), (nb,),
                  torch.int32)
    _int_operands("bond_rows", (b.active,), (nb,), torch.bool)
    _int_operands("bond_rows", (genome.n_modes,), (), torch.int32)
    check_layout("bond_rows", tables, tables[0].shape)
    if tables[0].dim() != 1 or tables[0].numel() < 1:
        raise ValueError("bond_rows: expected the genome's per-mode tables "
                         "as 1-D tensors of at least one mode")
    if rows * 7 >= 2 ** 31:
        raise ValueError(f"bond_rows: {rows} rows overflow the kernel's "
                         f"32-bit indexing")
    dt = params.dt if dt is None else dt
    out = torch.empty((rows, 7), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in (
        *cells, *bonds, genome.n_modes, *tables)))
    with torch.cuda.device(dev):
        rc = library().lib.sph_bond_rows(
            ptrs, out.data_ptr(), n, nb, rows, tables[0].numel(),
            int(bool(params.enable_anchor_constraints)),
            dt, dev.index, stream_of(dev))
    check_launch("bond_rows", rc)
    LAUNCHES["bond_rows"] += 1
    return out


def bond_scan(rows, plan, zero_bond=None):
    """Drop-in for sph_tpu_torch.physics.adhesion.
    accumulate_bond_deltas_planned: (Δv [n, 3], Δq [n, 4]) of the [Mp, 7]
    row table through the plan's frozen order, with the rows of the bonds
    in `zero_bond` [B] (optional) zeroed. The plan's `last` must point at
    rows that end a run, as every BondPlan's does. On the card, two
    launches on the stream's cursor (ops.contact.launch_on_cursor)."""
    if rows.device.type == "cpu":
        return adhesion.accumulate_bond_deltas_planned(rows, plan, zero_bond)
    name = "bond_scan"
    dev = rows.device
    w = adhesion._SEG_W
    mp, n = rows.shape[0] if rows.dim() else 0, plan.last.shape[0]
    if rows.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 rows, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != 7 or mp < w or mp % w:
        raise ValueError(f"{name}: expected rows of shape [Mp, 7], Mp a "
                         f"positive multiple of {w}, got "
                         f"{tuple(rows.shape)}")
    # Before the layouts, so that a stride-0 view can show the refusal.
    if max(mp, n) * 7 >= 2 ** 31:
        raise ValueError(f"{name}: {max(mp, n)} rows overflow the kernel's "
                         f"32-bit indexing")
    zb = () if zero_bond is None else (zero_bond,)
    check_device(name, (rows, plan.perm, plan.flags, plan.last, plan.has,
                        *zb), dev)
    check_layout(name, (rows,), (mp, 7))
    _int_operands(name, (plan.perm,), (mp,), torch.int64)
    _int_operands(name, (plan.flags,), (mp,), torch.bool)
    _int_operands(name, (plan.last,), (n,), torch.int64)
    _int_operands(name, (plan.has,), (n,), torch.bool)
    b = zero_bond.shape[0] if zero_bond is not None and zero_bond.dim() else 0
    _int_operands(name, zb, (b,), torch.bool)
    if 2 * b > mp:
        raise ValueError(f"{name}: zero_bond of {b} bonds for {mp} rows")
    mb = mp // w
    out = torch.empty((n, 7), dtype=torch.float32, device=dev)
    v_in = torch.empty((mp, 7), dtype=torch.float32, device=dev)
    f_in = torch.empty((mp,), dtype=torch.uint8, device=dev)
    # The block totals and their scan's buffers: values [2][7][mb]; flags
    # [1 + 2·7][mb], the totals' own, then two a component.
    tv = torch.empty((2, 7, mb), dtype=torch.float32, device=dev)
    tf = torch.empty((15, mb), dtype=torch.uint8, device=dev)
    stream = stream_of(dev)
    with torch.cuda.device(dev):
        launch_on_cursor(name, dev, stream, lambda cursor: (
            library().lib.sph_bond_scan(
                rows.data_ptr(), plan.perm.data_ptr(), plan.flags.data_ptr(),
                plan.last.data_ptr(), plan.has.data_ptr(),
                None if zero_bond is None else zero_bond.data_ptr(), b,
                out.data_ptr(), v_in.data_ptr(), f_in.data_ptr(),
                tv.data_ptr(), tf.data_ptr(), cursor, mp, n, stream)))
    LAUNCHES[name] += 1
    return out[:, :3], out[:, 3:]
