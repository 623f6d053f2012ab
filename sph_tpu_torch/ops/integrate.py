"""Wrappers of the dense step's per-slot tail, `csrc/integrate.cu`: F1
(`integrate`, the counterpart of `_integrate`, sph_tpu/sph/dense.py:460)
and F2 (`density_tail`: the density fixup, the Tait EOS and p/ρ² of
`dense_step`, sph_tpu/sph/dense.py:682-687). The JAX package has no
Pallas kernel here: XLA fuses this code inside its jitted step.

A CPU tensor goes to the plain version (sph_tpu_torch.sph.dense
`_integrate`, `density_tail`); a CUDA tensor launches the kernel or raises
— there is no fallback. Outputs are fresh (torch.empty; the clamp and
push counts one torch.zeros of two, which the kernel adds to); kernels
launch on PyTorch's current stream and are not synchronised. Python floats
reach the kernels as f32, rounded as torch rounds a scalar that meets an
f32 tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sph_tpu_torch.ops import LAUNCHES
from sph_tpu_torch.ops.build import (
    check_device,
    check_launch,
    check_layout,
    library,
    stream_of,
)
from sph_tpu_torch.sph import dense

OBSTACLE_KINDS = {"sphere": 0, "box": 1, "cylinder_z": 2}   # csrc/integrate.cu
MAX_OBSTACLES = 8
# Exponents torch's pow does not take to powf (a fill, a copy, a square
# root, a reciprocal, products): the Tait EOS uses gamma = 7.
SPECIAL_EXPONENTS = (0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """The reciprocal torch multiplies by when it divides a CUDA tensor by
    a Python float: 1 / x in double, rounded to f32 (not the f32 quotient
    1 / f32(x): at config[3]'s particle mass 4.8e-4 the two differ)."""
    return float(np.float32(1.0 / x))


def _operands(name: str, tensors) -> int:
    """Raise unless the tensors are contiguous f32 CUDA tensors of one
    shape on one device, with at least one slot; returns the slot count."""
    check_device(name, tensors, tensors[0].device)
    check_layout(name, tensors, tensors[0].shape)
    n = tensors[0].numel()
    if n < 1:
        raise ValueError(f"{name}: expected at least one slot")
    return n


def obstacle_table(obstacles) -> tuple:
    """(kinds, geometry) of `params.obstacles` as the kernel takes them:
    int32 kinds and 6 f32 a obstacle (centre, then the radius or the half
    extents; a cylinder's centre has two coordinates)."""
    if len(obstacles) > MAX_OBSTACLES:
        raise ValueError(f"integrate: the kernel takes at most "
                         f"{MAX_OBSTACLES} obstacles, got {len(obstacles)}")
    kinds, geometry = [], []
    for ob in obstacles:
        if ob[0] not in OBSTACLE_KINDS:
            raise ValueError(f"unknown obstacle kind {ob[0]!r}")
        centre = list(ob[1]) + [0.0] * (3 - len(ob[1]))
        extent = (list(ob[2]) if ob[0] == "box" else [ob[2]]) + [0.0] * 2
        kinds.append(OBSTACLE_KINDS[ob[0]])
        geometry += [_f32(v) for v in centre[:3] + extent[:3]]
    n = max(len(kinds), 1)
    return ((ctypes.c_int * n)(*kinds),
            (ctypes.c_float * (6 * n))(*geometry))


def _drag_pointers(drag, device):
    """The drag's four device tensors (center, radius, target, strength) as
    the kernel reads them, or None."""
    if drag is None:
        return None
    parts = (drag.center, drag.radius, drag.target, drag.strength)
    for t, numel in zip(parts, (3, 1, 3, 1)):
        if (t.device != device or t.dtype != torch.float32
                or t.numel() != numel or not t.is_contiguous()):
            raise ValueError(f"integrate: the drag's tensors must be "
                             f"contiguous f32 on {device} (center and "
                             f"target of 3, radius and strength of 1)")
    return (ctypes.c_void_p * 4)(*(t.data_ptr() for t in parts))


def integrate(d, ax, ay, az, params, vmax: float, drag=None):
    """Drop-in for sph_tpu_torch.sph.dense._integrate: (px, py, pz, vx, vy,
    vz, n_clamped, n_pushed), the counts int32 0-dim tensors."""
    if d.px.device.type == "cpu":
        return dense._integrate(d, ax, ay, az, params, vmax, drag=drag)
    ins = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, ax, ay, az, d.occ)
    n = _operands("integrate", ins)
    dev = d.px.device
    kinds, geometry = obstacle_table(params.obstacles)
    drag_ptrs = _drag_pointers(drag, dev)
    lo, hi = params.bounds_min, params.bounds_max
    consts = (ctypes.c_float * 13)(
        _f32(params.dt), _f32(params.gravity), _f32(vmax),
        _f32(-params.boundary_damping), _f32(params.h * 0.5),
        _f32(params.obstacle_stiffness), _recip(params.particle_mass),
        *(_f32(v) for v in lo), *(_f32(v) for v in hi))
    lib = library().lib
    outs = [torch.empty_like(d.px) for _ in range(6)]
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sph_integrate(
            (ctypes.c_void_p * 10)(*(t.data_ptr() for t in ins)),
            (ctypes.c_void_p * 6)(*(t.data_ptr() for t in outs)),
            counts.data_ptr(), n, params.ndim, consts,
            len(params.obstacles), kinds, geometry, drag_ptrs, dev.index,
            stream_of(dev))
    check_launch("integrate", rc)
    LAUNCHES["integrate"] += 1
    return (*outs, counts[0], counts[1])


def density_tail(raw, occ, params):
    """(ρ, p, p/ρ²) from K1's raw ρ and the occupancy: the plain
    dense.density_tail's bits."""
    if raw.device.type == "cpu":
        return dense.density_tail(raw, occ, params)
    if params.gamma in SPECIAL_EXPONENTS:
        raise ValueError(f"density_tail: the kernel computes the general "
                         f"pow; torch specialises gamma={params.gamma}")
    n = _operands("density_tail", (raw, occ))
    dev = raw.device
    consts = (ctypes.c_float * 5)(
        _f32(1e-6), _f32(params.rest_density),      # density_fixup's floor
        _recip(params.rest_density), _f32(params.gamma),
        _f32(params.tait_b))
    lib = library().lib
    outs = [torch.empty_like(raw) for _ in range(3)]
    with torch.cuda.device(dev):
        rc = lib.sph_density_tail(
            raw.data_ptr(), occ.data_ptr(), *(t.data_ptr() for t in outs),
            n, consts, dev.index, stream_of(dev))
    check_launch("density_tail", rc)
    LAUNCHES["density_tail"] += 1
    return tuple(outs)
