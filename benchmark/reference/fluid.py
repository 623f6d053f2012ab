"""Plain weakly compressible SPH (WCSPH) in PyTorch on flat particle
arrays: the reference of the dam-break cells. float32 with TF32 off
(dtype= runs it in another precision: the control), neighbours by the cell
list of reference/grid.py, every particle kept by construction (there is
no layout to overflow). No code of the program.

One step of particles at x with velocity v, r_ij = |x_i − x_j|:

    ρ_i = m·C6·Σ_j (h² − r_ij²)³ over r_ij < h, self term j = i included
    ρ_i ← max(ρ_i, 1e-6)
    p_i = max(B·((ρ_i/ρ0)^γ − 1), 0),  B = ρ0·c²/γ
    a_i = Σ_j m·Cs·(h − r_ij)²/r_ij·(p_i/ρ_i² + p_j/ρ_j²)·(x_i − x_j)
          + μ·m·Cv·(h − r_ij)·(v_j − v_i)/(ρ_i·ρ_j)      (0 < r_ij < h)
    a_i ← a_i − g·ŷ + Σ_obstacles k·max(h/2 − sd(x_i), 0)·n(x_i)
    v_i ← v_i + a_i·dt, scaled down to |v_i| ≤ vmax
    x_i ← x_i + v_i·dt
    walls: each coordinate clamped into the box; a velocity component whose
    coordinate left it is multiplied by −boundary_damping

with Müller et al. (2003)'s kernels: C6 = 315/(64π h⁹) (poly6),
Cs = 45/(π h⁶) (spiky gradient), Cv = 45/(π h⁶) (viscosity Laplacian).

Departures from a textbook WCSPH (Becker & Teschner 2007), each as the
configuration states the system:
- the Tait pressure is clamped at 0: no tensile (negative) pressure;
- an obstacle is a penalty push along its signed distance field's normal
  within h/2 of its surface (stiffness k), not a layer of boundary
  particles; the walls reflect and damp instead;
- the speed is clamped to vmax, a limit the configuration's layout sets
  (the program's cell grid must reach every particle between rebins);
- ρ is floored at 1e-6 before the EOS;
- pairs closer than 1e-8 (r² ≤ 1e-16) add density but no force.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.grid import pairs_within


def _obstacle_accel(x, ph):
    acc = torch.zeros_like(x)
    for kind, centre, radius in ph["obstacles"]:
        if kind != "cylinder_z":
            raise ValueError(f"the reference has no obstacle {kind!r}")
        d = x[:, :2] - torch.tensor(centre, dtype=x.dtype, device=x.device)
        dist = torch.sqrt((d * d).sum(-1))
        normal = d / torch.clamp_min(dist, 1e-9)[:, None]
        pen = torch.clamp_min(ph["h"] * 0.5 - (dist - radius), 0.0)
        acc[:, :2] += normal * (pen * ph["obstacle_stiffness"])[:, None]
    return acc


def step(x, v, ph):
    """One step; returns (x, v, ρ) with ρ that of the step's start."""
    h, m = ph["h"], ph["particle_mass"]
    n = len(x)
    i, j = pairs_within(x, h)
    d = x[i] - x[j]
    r2 = (d * d).sum(-1)

    c6 = 315.0 / (64.0 * math.pi * h ** 9)
    w = torch.clamp_min(h * h - r2, 0.0) ** 3
    rho = torch.full((n,), (h * h) ** 3, dtype=x.dtype, device=x.device)
    rho = m * c6 * rho.index_add(0, i, w)
    rho = torch.clamp_min(rho, 1e-6)
    b = ph["rest_density"] * ph["sound_speed"] ** 2 / ph["gamma"]
    p = torch.clamp_min(
        b * ((rho / ph["rest_density"]) ** ph["gamma"] - 1.0), 0.0)
    pr2 = p / (rho * rho)

    apart = r2 > 1e-16
    i, j, d, r2 = i[apart], j[apart], d[apart], r2[apart]
    r = torch.sqrt(r2)
    hr = torch.clamp_min(h - r, 0.0)
    cs = 45.0 / (math.pi * h ** 6)
    cv = 45.0 / (math.pi * h ** 6)
    fp = (m * cs) * hr * hr / r * (pr2[i] + pr2[j])
    fv = (ph["viscosity"] * m * cv) * hr / (rho[i] * rho[j])
    a = torch.zeros_like(x).index_add(
        0, i, fp[:, None] * d + fv[:, None] * (v[j] - v[i]))
    a[:, 1] -= ph["gravity"]
    a = a + _obstacle_accel(x, ph)

    dt = ph["dt"]
    v = v + a * dt
    speed = torch.sqrt((v * v).sum(-1))
    v = v * torch.clamp_max(ph["vmax"] / torch.clamp_min(speed, 1e-12),
                            1.0)[:, None]
    x = x + v * dt
    lo = torch.tensor(ph["bounds_min"], dtype=x.dtype, device=x.device)
    hi = torch.tensor(ph["bounds_max"], dtype=x.dtype, device=x.device)
    out = (x < lo) | (x > hi)
    x = torch.minimum(torch.maximum(x, lo), hi)
    v = torch.where(out, -ph["boundary_damping"] * v, v)
    return x, v, rho


def run(start: dict, ph: dict, steps: int,
        dtype=torch.float32) -> dict:
    """`steps` steps from start {"pos", "vel"} ([N, 3] each) with the
    physics `ph`; returns {"pos", "vel", "rho"} in float32, ρ that of the
    last step's start (as the program's state holds it)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, v = start["pos"].to(dtype), start["vel"].to(dtype)
        rho = None
        for _ in range(steps):
            x, v, rho = step(x, v, ph)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"pos": x.float(), "vel": v.float(), "rho": rho.float()}
