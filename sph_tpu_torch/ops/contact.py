"""Wrapper of the colony contact sweep kernel K4, `csrc/contact_sweep.cu`
— the counterpart of `contact_sweep_pallas` (sph_tpu/ops/pallas/
contact.py).

A CPU tensor goes to the plain `_sweep_plain`
(sph_tpu_torch.physics.contact_dense); a CUDA tensor launches the kernel or
raises — there is no fallback. On the card the kernel equals the plain
version bitwise (same terms, same order, no FMA); the contract it is held
to is the JAX twin's, rtol 1e-5 and atol 1e-6·max|x| on every slot.
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

NCOMP = 6  # force[3], torque[3]


def contact_sweep(fields, occ, params, spec):
    """Own-side force and torque per slot: 6 [Z, Y, L] planes. `fields`
    are the 10 packed planes (px, py, pz, vx, vy, vz, ox, oy, oz, rad),
    `occ` the occupancy plane."""
    from sph_tpu_torch.physics import contact_dense as cd

    if fields[0].device.type == "cpu":
        return cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(params, *a), NCOMP,
            spec)
    dev = fields[0].device
    check_operands("contact_sweep", (*fields, occ), spec.shape(), dev)
    if len(fields) != 10:
        raise ValueError(f"contact_sweep: expected 10 fields, got "
                         f"{len(fields)}")
    outs = [torch.empty_like(occ) for _ in range(NCOMP)]
    ins_p = (ctypes.c_void_p * 10)(*(f.data_ptr() for f in fields))
    outs_p = (ctypes.c_void_p * NCOMP)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        rc = library().lib.sph_contact_sweep(
            ins_p, occ.data_ptr(), outs_p, spec.nz, spec.ny, spec.L, spec.k,
            params.contact_epsilon, params.slip_epsilon,
            params.repulsion_strength, params.torque_factor,
            params.rolling_contact_radius_multiplier, stream_of(dev))
    check_launch("contact_sweep", rc)
    LAUNCHES["contact"] += 1
    return outs
