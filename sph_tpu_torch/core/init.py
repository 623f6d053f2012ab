"""Particle initialisation (InitParticles, SimulateParticles.compute:118-194)
— the counterpart of sph_tpu.core.init.

Two modes:

- `"hash_sin"` reproduces the reference's `frac(sin(seed·k)·m)` generator
  bitwise with the JAX package. Its host math is f32 numpy, with `sin` and
  `cbrt` taken from the C library (`sinf`, and `powf(x, 1/3)` for x ≥ 0),
  which is what XLA's CPU backend calls for them: one ulp of `sin` moves
  the hash's fractional part by ~4e-3, so no other implementation will do.
- `"jax"` (the JAX package's default name): the same distributions —
  uniform in the sphere by a cube-root radius, radius ~ U[min, max], drag
  ~ U[0.5, 1], mode 50% initial / 50% uniform — drawn from a
  torch.Generator seeded with `seed`. JAX's threefry stream cannot be
  reproduced, so parity tests hand the port JAX's initial state instead.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from sph_tpu_torch.core.types import GenomeDevice, SimParams, SimState

f32 = np.float32

_LIBM = None


def _libm():
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for name, nargs in (("sinf", 1), ("powf", 2)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.c_float] * nargs
        _LIBM = lib
    return _LIBM


def _sinf(x: np.ndarray) -> np.ndarray:
    fn = _libm().sinf
    return np.fromiter((fn(v) for v in x.tolist()), f32, count=x.size)


def _cbrtf(x: np.ndarray) -> np.ndarray:
    """cbrt of non-negative f32 values, as powf(x, f32(1/3))."""
    fn = _libm().powf
    third = float(f32(1.0 / 3.0))
    return np.fromiter((fn(v, third) for v in x.tolist()), f32,
                       count=x.size)


def _hash_sin(seed: np.ndarray, k: float, m: float) -> np.ndarray:
    """frac(sin(seed·k)·m) in f32 (compute:134-141)."""
    x = _sinf(seed * f32(k)) * f32(m)
    return x - np.floor(x)


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    return v / np.maximum(n, f32(1e-12))


def _init_fields_hash_sin(N: int, params: SimParams, n_modes: int,
                          default_mode: int):
    ids = np.arange(N, dtype=np.uint32)
    seed = (ids * np.uint32(65537) + np.uint32(17)).astype(f32)  # :123

    def rand3(k1, k2, k3):
        return np.stack([
            _hash_sin(seed, k1, 43758.5453) * f32(2) - f32(1),
            _hash_sin(seed, k2, 43758.5453) * f32(2) - f32(1),
            _hash_sin(seed, k3, 43758.5453) * f32(2) - f32(1),
        ], axis=-1)

    dirv = _unit(rand3(12.9898, 78.233, 91.934))
    rand_val = _hash_sin(seed, 1.2345, 10000.0)
    dist = _cbrtf(rand_val) * f32(params.spawn_radius)
    pos = dirv * dist[:, None]
    # Stratified anti-clump nudge for id > 1 (compute:147-155).
    repel = (_cbrtf(f32(0.5) * ids.astype(f32) / f32(N))
             * f32(params.spawn_radius) * f32(0.1))
    nudge = _unit(rand3(45.678, 67.890, 12.345))
    pos = np.where((ids > 1)[:, None], pos + nudge * repel[:, None], pos)
    pos = np.where((ids == 0)[:, None], f32(0), pos).astype(f32)

    radius = f32(params.min_radius) + f32(
        params.max_radius - params.min_radius) * _hash_sin(seed, 3.456, 999.0)
    drag = f32(0.5) + f32(0.5) * _hash_sin(seed, 5.6789, 888.0)

    if n_modes > 0:
        use_default = _hash_sin(seed, 78.123, 5432.1) < f32(0.5)
        rand_mode = (_hash_sin(seed, 43.21, 8765.43)
                     * f32(n_modes)).astype(np.int32)
        mode = np.where(use_default, np.int32(default_mode), rand_mode)
        mode = np.clip(mode, 0, n_modes - 1).astype(np.int32)
    else:
        mode = np.full(N, -1, np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (pos, radius.astype(f32), drag.astype(f32), mode)]


def _init_fields_random(seed: int, N: int, params: SimParams, n_modes: int,
                        default_mode: int):
    g = torch.Generator().manual_seed(seed)
    dirv = torch.randn((N, 3), generator=g)
    dirv = dirv / torch.clamp(dirv.norm(dim=-1, keepdim=True), min=1e-12)
    dist = torch.rand(N, generator=g).pow(1.0 / 3.0) * params.spawn_radius
    pos = dirv * dist[:, None]
    ids = torch.arange(N)
    repel = (0.5 * ids.float() / N).pow(1.0 / 3.0) * params.spawn_radius * 0.1
    nudge = torch.randn((N, 3), generator=g)
    nudge = nudge / torch.clamp(nudge.norm(dim=-1, keepdim=True), min=1e-12)
    pos = torch.where((ids > 1)[:, None], pos + nudge * repel[:, None], pos)
    pos = torch.where((ids == 0)[:, None], 0.0, pos)
    radius = params.min_radius + (params.max_radius - params.min_radius) * \
        torch.rand(N, generator=g)
    drag = 0.5 + 0.5 * torch.rand(N, generator=g)
    if n_modes > 0:
        use_default = torch.rand(N, generator=g) < 0.5
        rand_mode = torch.randint(0, n_modes, (N,), generator=g)
        mode = torch.where(use_default, default_mode, rand_mode).int()
    else:
        mode = torch.full((N,), -1, dtype=torch.int32)
    return pos, radius, drag, mode


def init_particles(
    params: SimParams,
    genome_dev: GenomeDevice | None,
    n_modes: int,
    initial_mode: int,
    capacity: int | None = None,
    active_count: int = 1,
    seed: int = 0,
    rng_mode: str = "jax",
    device="cuda",
) -> SimState:
    """A fresh SimState on `device` (Start / InitializeParticles,
    cs:211-233, :484-552): every slot gets initialised fields,
    `active_count` defaults to 1, slot 0's mode is the genome's initial
    mode (cs:516-523) and its identity is 00.00.A (cs:490-493). The PRNG
    key stays the PRNGKey(seed) words (the JAX package carries a split of
    it; neither package draws from it after init)."""
    N = capacity if capacity is not None else params.capacity
    state = SimState.zeros(N, params, seed=seed, device=device)
    if rng_mode == "hash_sin":
        pos, radius, drag, mode = _init_fields_hash_sin(
            N, params, n_modes, initial_mode)
    elif rng_mode == "jax":
        pos, radius, drag, mode = _init_fields_random(
            seed, N, params, n_modes, initial_mode)
    else:
        raise ValueError(f"unknown rng_mode {rng_mode!r}")

    radius = radius.to(torch.float32)
    volume = (4.0 / 3.0) * math.pi * radius ** 3
    mass = params.density * volume
    inertia = 0.4 * mass * radius ** 2
    mode = mode.clone()
    mode[0] = initial_mode if n_modes > 0 else -1
    uid = torch.full((N,), -1, dtype=torch.int32)
    uid[0] = 0
    to = dict(device=device)
    return state.replace_fields(
        pos=pos.to(dtype=torch.float32, **to),
        radius=radius.to(**to),
        mass=mass.to(dtype=torch.float32, **to),
        inertia=inertia.to(dtype=torch.float32, **to),
        drag=drag.to(dtype=torch.float32, **to),
        mode=mode.to(dtype=torch.int32, **to),
        uid=uid.to(**to),
        active_count=torch.full((), active_count, dtype=torch.int32, **to),
        next_uid=torch.full((), 1, dtype=torch.int32, **to),
    )
