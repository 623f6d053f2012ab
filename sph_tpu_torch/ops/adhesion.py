"""Wrapper of the adhesion pass's per-bond kernel A1, `csrc/adhesion.cu`
`bond_rows_kernel`: the endpoint gather, the spring parameters, the
spring, anchor-swing and relative-orientation deltas of every bond, and
the [Mp, 7] row table the accumulates read. The JAX package has no Pallas
kernel here: XLA fuses `bond_spring_params` and `bond_pair_deltas`
(sph_tpu/physics/adhesion.py) inside its jitted step.

A CPU tensor goes to the plain version (sph_tpu_torch.physics.adhesion
`bond_rows`); a CUDA tensor launches the kernel, once a call, or raises —
there is no fallback. The table is fresh (torch.empty: the kernel writes
every row, the pad rows too); the kernel launches on PyTorch's current
stream and is not synchronised, and reads the genome's mode count on the
device, so a call makes no host read. dt reaches the kernel as f32, as
torch rounds a Python float that meets an f32 tensor.
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
