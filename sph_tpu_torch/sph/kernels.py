"""SPH smoothing kernels (Müller et al. 2003 poly6/spiky/viscosity family),
with correct 2D and 3D normalizations — the counterpart of
sph_tpu.sph.kernels. The coefficients are Python floats computed exactly as
the JAX package computes them, so both packages round the same doubles to
f32 at the point of use."""

from __future__ import annotations

import math

import torch


def poly6_coeff(h: float, ndim: int) -> float:
    if ndim == 3:
        return 315.0 / (64.0 * math.pi * h ** 9)
    return 4.0 / (math.pi * h ** 8)


def spiky_grad_coeff(h: float, ndim: int) -> float:
    if ndim == 3:
        return -45.0 / (math.pi * h ** 6)
    return -30.0 / (math.pi * h ** 5)


def viscosity_lap_coeff(h: float, ndim: int) -> float:
    if ndim == 3:
        return 45.0 / (math.pi * h ** 6)
    return 40.0 / (math.pi * h ** 5)


def w_poly6(r2: torch.Tensor, h: float, ndim: int) -> torch.Tensor:
    """W(r) = C·(h² − r²)³ for r < h (takes r² to skip the sqrt)."""
    h2 = h * h
    d = torch.clamp_min(h2 - r2, 0.0)
    return poly6_coeff(h, ndim) * d * d * d


def grad_w_spiky(r_vec: torch.Tensor, r: torch.Tensor, h: float,
                 ndim: int) -> torch.Tensor:
    """∇W_spiky = C·(h − r)²·r̂ for 0 < r < h (C < 0: points inward)."""
    d = torch.clamp_min(h - r, 0.0)
    safe_r = torch.clamp_min(r, 1e-12)
    coeff = spiky_grad_coeff(h, ndim) * d * d / safe_r
    return r_vec * coeff[..., None]


def lap_w_viscosity(r: torch.Tensor, h: float, ndim: int) -> torch.Tensor:
    """∇²W_visc = C·(h − r) for r < h."""
    return viscosity_lap_coeff(h, ndim) * torch.clamp_min(h - r, 0.0)
