"""Wrappers of the dense-step pair-sweep kernels K1 (density) and K2
(pressure + viscosity acceleration), `csrc/fluid_sweep.cu` — the
counterparts of `density_pallas` / `accel_pallas`
(sph_tpu/ops/pallas/fluid.py).

A CPU tensor goes to the plain version (sph_tpu_torch.sph.dense); a CUDA
tensor launches the kernel or raises — there is no fallback. Outputs are
allocated here with torch.empty; kernels launch on PyTorch's current stream
and are not synchronised.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_launch,
    check_operands,
    library,
    stream_of,
)
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph import kernels as KN


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX rounds its weak-typed scalars
    (ctypes.c_float rounds the same way)."""
    return float(np.float32(x))


def density_sweep(px, py, pz, occ, params, spec) -> torch.Tensor:
    """Scaled raw ρ over every slot (caller applies the occupancy fixup);
    empty slots come back 0 from the kernel, occupied ones bitwise equal to
    the plain dense.density_raw."""
    if px.device.type == "cpu":
        return dense.density_raw(px, py, pz, params, spec)
    shape = (spec.n0, spec.k, spec.C)
    check_operands("density_sweep", (px, py, pz, occ), shape, px.device)
    lib = library().lib
    out = torch.empty_like(px)
    scale = params.particle_mass * KN.poly6_coeff(params.h, params.ndim)
    with torch.cuda.device(px.device):
        rc = lib.sph_density_sweep(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), occ.data_ptr(),
            out.data_ptr(), spec.n0, spec.k, spec.C, spec.X,
            int(spec.stencil0), int(spec.stencil1),
            _f32(params.h * params.h), dense.density_self_term(params),
            _f32(scale), stream_of(px.device),
        )
    check_launch("density_sweep", rc)
    LAUNCHES["density"] += 1
    return out


def accel_sweep(d, pr2, params, spec):
    """Pressure + viscosity acceleration (no gravity/obstacles here);
    empty slots come back 0 from the kernel, occupied ones bitwise equal to
    the plain dense.accel_raw."""
    irho = torch.reciprocal(d.rho)
    if d.px.device.type == "cpu":
        return dense.accel_raw(d, irho, pr2, params, spec)
    shape = (spec.n0, spec.k, spec.C)
    ins = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, irho, pr2, d.occ)
    check_operands("accel_sweep", ins, shape, d.px.device)
    lib = library().lib
    outs = [torch.empty_like(d.px) for _ in range(3)]
    h, neg_m_spiky, visc_mc = dense.accel_constants(params)
    with torch.cuda.device(d.px.device):
        rc = lib.sph_accel_sweep(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            spec.n0, spec.k, spec.C, spec.X,
            int(spec.stencil0), int(spec.stencil1),
            _f32(h), _f32(neg_m_spiky), _f32(visc_mc),
            stream_of(d.px.device),
        )
    check_launch("accel_sweep", rc)
    LAUNCHES["accel"] += 1
    return tuple(outs)
