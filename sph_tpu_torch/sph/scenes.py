"""Scene builders for the BASELINE config ladder (sph_tpu.sph.scenes):

0. 2D dam-break, 4k
1. 2D splash/pour, 32k
2. 3D dam-break, 256k
3. 3D + SDF obstacles, 1M

The lattice is pure numpy and identical to the JAX package's, so both
packages start from bit-identical positions. States are built on the CPU;
`FluidSimulation` moves the packed layout to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_tpu_torch.sph.model import SPHParams, SPHState


def _lattice(lo, hi, dx, ndim, jitter=0.0, seed=0):
    """Regular particle lattice filling [lo, hi) with spacing dx."""
    axes = [np.arange(lo[a] + dx * 0.5, hi[a], dx) for a in range(ndim)]
    if ndim == 2:
        x, y = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([x.ravel(), y.ravel(), np.zeros(x.size)], axis=-1)
    else:
        x, y, z = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        pts[:, :ndim] += rng.uniform(-jitter, jitter, (len(pts), ndim)) * dx
    return pts.astype(np.float32)


def _fluid_params(ndim, dx, bounds_max, **overrides) -> SPHParams:
    h = 1.3 * dx                     # ~30 (3D) / ~12 (2D) neighbors
    rest = 1000.0
    mass = rest * dx ** ndim
    c = 60.0                         # ≳10× expected max flow speed
    dt = 0.25 * h / c                # CFL
    base = SPHParams(
        ndim=ndim, h=h, rest_density=rest, particle_mass=mass,
        sound_speed=c, viscosity=0.2 if ndim == 2 else 0.05,
        dt=dt, bounds_min=(0.0, 0.0, 0.0), bounds_max=bounds_max,
    )
    return base.replace(**overrides) if overrides else base


def _state(pts: np.ndarray, params: SPHParams) -> SPHState:
    return SPHState.from_positions(torch.from_numpy(pts), params)


def dam_break_2d(n_target: int = 4096, **overrides):
    """Config[0/1]: fluid column released in a 2×1 tank."""
    area = 0.5 * 0.8
    dx = float(np.sqrt(area / n_target))
    pts = _lattice((0.0, 0.0), (0.5, 0.8), dx, ndim=2)
    params = _fluid_params(2, dx, (2.0, 1.0, 0.0), **overrides)
    return _state(pts, params), params


def splash_pour_2d(n_target: int = 32768, **overrides):
    """Config[1]: a pool plus a falling block that splashes into it."""
    pool_area = 2.0 * 0.3
    block_area = 0.5 * 0.5
    dx = float(np.sqrt((pool_area + block_area) / n_target))
    pool = _lattice((0.0, 0.0), (2.0, 0.3), dx, ndim=2)
    block = _lattice((0.75, 0.7), (1.25, 1.2), dx, ndim=2)
    pts = np.concatenate([pool, block])
    params = _fluid_params(2, dx, (2.0, 1.5, 0.0), **overrides)
    return _state(pts, params), params


def dam_break_3d(n_target: int = 262144, obstacles=(), **overrides):
    """Config[2/3]: classic 3D dam break in a 2×1×1 tank; optional SDF
    obstacles in the flow path (config[3])."""
    vol = 0.6 * 0.8 * 1.0
    dx = float(np.cbrt(vol / n_target))
    pts = _lattice((0.0, 0.0, 0.0), (0.6, 0.8, 1.0), dx, ndim=3)
    params = _fluid_params(
        3, dx, (2.0, 1.0, 1.0), obstacles=tuple(obstacles), **overrides
    )
    return _state(pts, params), params


# Config[3]'s dense layout: 16 slots a cell of 1.3 h, a rebin every 2
# steps. Measured from the seeded column through the pillar's impact to the
# far wall (8,900 steps, 3 seeds a layout, PERF.md §4): unclamped, the flow
# reaches 13.1 m/s, and the speed limit a layout sets ((cell − h)/2 a rebin
# interval) held ~255,000 lanes at a rebin every 5 steps (7.2 m/s), ~14,000
# at every 4 and up to 37 at every 3 (12 m/s); at every 2 steps (18 m/s) it
# held none, the flow stayed below 0.71 of it, and the rebin never sought
# more than 13 of 16 slots of a cell nor dropped a particle. At 8 slots,
# 1.38 h and every 6 steps the rebin dropped ~9% of the column in the
# collapse alone.
CONFIG3_LAYOUT = dict(dense_k=16, cell_factor=1.3, rebin_every=2)
# Each dense config's layout (slots a cell, cell side in h, steps between
# rebins): config[1], [2] and [4] at the JAX bench's (bench.py), config[3]
# at the port's own. The port's bench and chip_smoke.py read them here.
LAYOUTS = {
    1: dict(dense_k=8, cell_factor=1.2, rebin_every=3),
    2: dict(dense_k=8, cell_factor=1.25, rebin_every=6),
    3: CONFIG3_LAYOUT,
    4: dict(dense_k=8, cell_factor=1.35, rebin_every=6),
}


def dam_break_3d_obstacle(n_target: int = 1_000_000, **overrides):
    """Config[3]: 1M-particle dam break hitting a cylindrical pillar, at
    CONFIG3_LAYOUT unless `overrides` name other layout keys."""
    return dam_break_3d(
        n_target,
        obstacles=(("cylinder_z", (1.2, 0.15), 0.12),),
        **{**CONFIG3_LAYOUT, **overrides},
    )
