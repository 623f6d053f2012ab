"""Prebuilt bonded-colony scenes — the counterpart of
sph_tpu.engine.colony, with the same output bit for bit.

A grown reference colony is cells packed at the genome's adhesion rest
length, every cell bonded to its neighbours (each division creates an A↔B
bond, CellAdhesionManager.cs:504-509). This builds that steady state
directly: a jittered simple-cubic lattice at the rest length carved to a
ball, a bond per lattice-neighbour pair, zones classified as FilterBonds
would see them, pruned to FilterBonds' fixed point, and anchors at the
surface point along each bond (radius 1.0, CAM:377-402).

The neighbour search is vectorised (a sorted key table and
np.searchsorted) and yields the pairs in the JAX package's order; a 1M-cell
colony builds in seconds, so the on-disk cache is optional (`cache_dir`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sph_tpu_torch.core.types import BondTable, Genome, SimParams, SimState
from sph_tpu_torch.engine.config import (
    reference_genome,
    reference_scene_params,
)

ZONE_A, ZONE_B, ZONE_C = 0, 1, 2


def _lattice_ball(n: int, spacing: float, jitter: float,
                  rng: np.random.Generator):
    """n points of a jittered simple-cubic lattice, nearest to the centre
    first."""
    m = int(np.ceil((3 * n / (4 * np.pi)) ** (1 / 3))) + 2
    ax = np.arange(-m, m + 1)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    d2 = np.sum(pts * pts, -1)
    order = np.argsort(d2, kind="stable")
    pts = pts[order[:n]] * spacing
    pts = pts + rng.uniform(-jitter, jitter, pts.shape)
    return pts.astype(np.float32)


def _neighbor_bonds(pos: np.ndarray, spacing: float):
    """Index pairs (i, j) of +axis lattice neighbours (≤ 3 per cell), in
    the JAX package's order: direction (x, y, z), then i ascending; where
    two cells share a lattice key the later one is the partner (a dict
    keeps the last write)."""
    key = np.round(pos / spacing).astype(np.int64)
    if len(key) == 0:
        return np.zeros((0, 2), np.int32)
    lo = key.min(0) - 1
    dims = key.max(0) - lo + 2

    def code(k):
        k = k - lo
        return (k[:, 0] * dims[1] + k[:, 1]) * dims[2] + k[:, 2]

    codes = code(key)
    order = np.argsort(codes, kind="stable")
    cs = codes[order]
    # Last index of each distinct code.
    is_last = np.r_[cs[1:] != cs[:-1], True]
    ucodes, uidx = cs[is_last], order[is_last]
    out = []
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        want = code(key + np.asarray(d, np.int64))
        at = np.minimum(np.searchsorted(ucodes, want), len(ucodes) - 1)
        hit = ucodes[at] == want
        i = np.nonzero(hit)[0]
        out.append(np.stack([i, uidx[at[hit]]], -1))
    return np.concatenate(out).astype(np.int32).reshape(-1, 2)


def _steady_state_prune(pairs, pos, zone_a, zone_b):
    """Host-side FilterBonds fixed point (CAM:184-243): among same-zone
    bonds sharing an endpoint only the shortest survives; bonds spanning
    ZoneC↔ZoneA/B exempt their groups."""
    B = len(pairs)
    if B == 0:
        return pairs
    ia, ib = pairs[:, 0], pairs[:, 1]
    dist = np.linalg.norm(
        (pos[ib] - pos[ia]).astype(np.float32), axis=-1).astype(np.float32)
    mixed = (zone_a == ZONE_C) != (zone_b == ZONE_C)
    off = 3 * np.int64(len(pos))
    keys = np.concatenate([ia.astype(np.int64) * 3 + zone_a,
                           off + ib.astype(np.int64) * 3 + zone_b])
    d2 = np.concatenate([dist, dist])
    idx2 = np.concatenate([np.arange(B), np.arange(B)])
    m2 = np.concatenate([mixed, mixed])
    gmix = np.zeros(int(keys.max()) + 1, bool)
    np.logical_or.at(gmix, keys, m2)
    order = np.lexsort((idx2, d2, keys))   # key, then dist, ties lowest idx
    ks = keys[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    rm2 = np.zeros(2 * B, bool)
    rm2[order] = ~first & ~gmix[ks]
    rm = rm2[:B] | rm2[B:]
    return pairs[~rm]


def _classify(dirs: np.ndarray, angle_deg: float = 10.0) -> np.ndarray:
    """Zone per bond END from the bond direction in the cell's frame
    (identity rotations; the reference genome splits along +z):
    ClassifyBondDirection, CAM:320-336."""
    dot = np.clip(dirs[:, 2], -1.0, 1.0)
    ang = np.degrees(np.arccos(dot))
    zone = np.where(dot > 0, ZONE_B, ZONE_A)
    return np.where(np.abs(ang - 90.0) <= angle_deg, ZONE_C, zone).astype(
        np.int32)


def colony_geometry(n: int, spacing: float, jitter: float, seed: int,
                    cache_dir=None):
    """(pos [n, 3] f32, pairs [B, 2] i32, rng) of the pruned colony; the
    rng has drawn the jitter. With `cache_dir`, (pos, pairs) are kept in
    an npz keyed by the inputs and reused."""
    rng = np.random.default_rng(seed)
    cache = None
    if cache_dir is not None:
        cache = (Path(cache_dir)
                 / f"colony_v1_n{n}_s{spacing!r}_j{jitter!r}_seed{seed}.npz")
        if cache.exists():
            with np.load(cache) as z:
                pos, pairs = z["pos"], z["pairs"]
            rng.uniform(-jitter, jitter, (n, 3))   # burn the jitter draw
            return pos, pairs, rng
    pos = _lattice_ball(n, spacing, jitter, rng)
    pairs = _neighbor_bonds(pos, spacing)
    # Prune to FilterBonds' fixed point (removals can cascade).
    while True:
        ia, ib = pairs[:, 0], pairs[:, 1]
        d0 = pos[ib] - pos[ia]
        d0 = d0 / np.maximum(np.linalg.norm(d0, axis=-1, keepdims=True),
                             1e-12)
        kept = _steady_state_prune(pairs, pos, _classify(d0), _classify(-d0))
        if len(kept) == len(pairs):
            break
        pairs = kept
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache, pos=pos, pairs=pairs)
    return pos, pairs, rng


def bonded_colony(n: int, genome: Genome | None = None, jitter: float = 0.35,
                  seed: int = 0, device="cuda", cache_dir=None,
                  **param_overrides) -> tuple[SimState, SimParams, Genome]:
    """A settled n-cell bonded colony and its scene params: cells on a
    jittered lattice at the genome's adhesion rest length (springs loaded,
    contacts only transient — rest length 2.96 > contact reach 2.0)."""
    genome = genome or reference_genome()
    spacing = float(genome.modes[0].adhesion_rest_length)
    pos, pairs, rng = colony_geometry(n, spacing, jitter, seed, cache_dir)
    R = float(np.linalg.norm(pos, axis=-1).max())
    nb = len(pairs)
    max_bonds = param_overrides.pop("max_bonds", None)
    if max_bonds is None:
        # Snug capacity: next multiple of 8192 with ≥ 5% headroom.
        max_bonds = -(-int(nb * 1.05 + 64) // 8192) * 8192
    param_overrides.setdefault("neighbor_mode", "dense")
    params = reference_scene_params(capacity=n, spawn_radius=R + 2.0 * spacing,
                                    max_bonds=max_bonds, **param_overrides)

    radius = np.full(n, params.max_radius, np.float32)
    volume = (4.0 / 3.0) * np.pi * radius ** 3
    mass = params.density * volume
    inertia = 0.4 * mass * radius ** 2

    ia, ib = pairs[:, 0], pairs[:, 1]
    delta = pos[ib] - pos[ia]
    dirs = delta / np.maximum(np.linalg.norm(delta, axis=-1, keepdims=True),
                              1e-12)
    B = max_bonds

    def pad(a, fill, dt):
        a = np.concatenate([a.astype(dt),
                            np.full((B - nb, *a.shape[1:]), fill, dt)])
        return torch.from_numpy(a).to(device)

    ident = np.zeros((nb, 4), np.float32)
    ident[:, 3] = 1.0
    bonds = BondTable(
        active=pad(np.ones(nb, bool), False, np.bool_),
        uid_a=pad(ia, -1, np.int32), uid_b=pad(ib, -1, np.int32),
        slot_a=pad(ia, -1, np.int32), slot_b=pad(ib, -1, np.int32),
        zone_a=pad(_classify(dirs), 0, np.int32),
        zone_b=pad(_classify(-dirs), 0, np.int32),
        child_to_child=pad(np.zeros(nb, bool), False, np.bool_),
        # Old enough that zones and anchors are final and every bond is
        # eligible for FilterBonds.
        created_step=pad(np.full(nb, -10), -10, np.int32),
        rel_orientation=pad(ident, 0.0, np.float32),
        # Surface point along the bond, radius 1.0 (CAM:377-402); body
        # frame == world frame at identity rotation.
        anchor_a=pad(dirs, 0.0, np.float32),
        anchor_b=pad(-dirs, 0.0, np.float32),
        anchors_set=pad(np.ones(nb, bool), False, np.bool_),
    )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = SimState.zeros(n, params, seed=seed, device=device)
    state = state.replace_fields(
        pos=dev(pos), radius=dev(radius),
        mass=dev(mass.astype(np.float32)),
        inertia=dev(inertia.astype(np.float32)),
        drag=dev(rng.uniform(0.5, 1.0, n).astype(np.float32)),
        mode=torch.zeros(n, dtype=torch.int32, device=device),
        uid=torch.arange(n, dtype=torch.int32, device=device),
        parent_uid=torch.full((n,), -1, dtype=torch.int32, device=device),
        active_count=torch.tensor(n, dtype=torch.int32, device=device),
        next_uid=torch.tensor(n, dtype=torch.int32, device=device),
        bonds=bonds,
    )
    return state, params, genome
