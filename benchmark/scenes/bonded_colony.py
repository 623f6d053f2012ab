"""Seeded inputs of a bonded colony: cells on a jittered simple cubic
lattice at the adhesion rest length, carved to a ball, a bond per
lattice-neighbour pair, zones classified and pruned to FilterBonds' fixed
point, anchors at the surface point along each bond.

Frozen copies of sph_tpu_torch/engine/colony.py (`_lattice_ball`,
`_neighbor_bonds`, `_steady_state_prune`, `_classify`, `colony_geometry`
and the per-cell and per-bond arrays of `bonded_colony`) at commit
5740b39, rewritten as torch operations on the run's device in a few large
calls. One torch.Generator on the device, seeded by --seed, draws the
jitter and then the drag coefficients.
"""

from __future__ import annotations

import math

import torch

ZONE_A, ZONE_B, ZONE_C = 0, 1, 2


def _lattice_ball(n: int, spacing: float, jitter: float, gen, device):
    m = int(math.ceil((3 * n / (4 * math.pi)) ** (1 / 3))) + 2
    ax = torch.arange(-m, m + 1, dtype=torch.float64, device=device)
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                      -1).reshape(-1, 3)
    order = torch.sort((pts * pts).sum(-1), stable=True).indices
    pts = pts[order[:n]] * spacing
    u = torch.rand(pts.shape, generator=gen, dtype=torch.float64,
                   device=device)
    return (pts + (2.0 * u - 1.0) * jitter).float()


def _neighbor_bonds(pos, spacing: float):
    """(i, j) of +axis lattice neighbours, direction-major, i ascending."""
    key = torch.round(pos.double() / spacing).long()
    lo = key.min(0).values - 1
    dims = key.max(0).values - lo + 2

    def code(k):
        k = k - lo
        return (k[:, 0] * dims[1] + k[:, 1]) * dims[2] + k[:, 2]

    codes = code(key)
    cs, order = torch.sort(codes, stable=True)
    is_last = torch.ones_like(cs, dtype=torch.bool)
    is_last[:-1] = cs[1:] != cs[:-1]
    ucodes, uidx = cs[is_last], order[is_last]
    out = []
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        want = code(key + torch.tensor(d, device=pos.device))
        at = torch.searchsorted(ucodes, want).clamp_max(len(ucodes) - 1)
        hit = ucodes[at] == want
        out.append(torch.stack([torch.nonzero(hit)[:, 0], uidx[at[hit]]],
                               -1))
    return torch.cat(out)


def _unit(d):
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)


def _classify(dirs, angle_deg: float):
    """Zone of a bond end from the bond direction (identity rotations)."""
    dot = torch.clamp(dirs[:, 2], -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(dot))
    zone = torch.where(dot > 0, ZONE_B, ZONE_A)
    return torch.where(torch.abs(ang - 90.0) <= angle_deg, ZONE_C, zone)


def _prune(pairs, pos, zone_a, zone_b):
    """One FilterBonds pass: per (cell, zone) group of each side, all but
    the shortest bond go, unless the group holds a ZoneC-to-A/B bond."""
    B = len(pairs)
    if B == 0:
        return pairs
    ia, ib = pairs[:, 0], pairs[:, 1]
    dist = torch.linalg.vector_norm(pos[ib] - pos[ia], dim=-1)
    mixed = (zone_a == ZONE_C) != (zone_b == ZONE_C)
    off = 3 * len(pos)
    keys = torch.cat([ia * 3 + zone_a, off + ib * 3 + zone_b])
    gmix = torch.zeros(off * 2, dtype=torch.int32, device=pos.device)
    gmix.index_add_(0, keys, torch.cat([mixed, mixed]).int())
    # The order of (key, distance, bond): a group's entries all come from
    # one side, so their place in `keys` orders them as the bond index does.
    order = torch.sort(torch.cat([dist, dist]), stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices]
    ks = keys[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    rm2 = torch.zeros(2 * B, dtype=torch.bool, device=pos.device)
    rm2[order] = ~first & (gmix[ks] == 0)
    return pairs[~(rm2[:B] | rm2[B:])]


def build(cfg: dict, seed: int, cells: int, device="cpu") -> dict:
    """The colony's tensors on `device` and its scene values:

    pos, radius, mass, inertia, drag [n]; bond endpoints ia, ib (int64),
    zones zone_a, zone_b and body-frame anchors anchor_a, anchor_b of the
    pruned bonds; spawn_radius (the boundary sphere: the ball's radius and
    two spacings) and max_bonds (the bond table's capacity)."""
    p = cfg["params"]
    g = cfg["genome_mode0"]
    spacing = float(g["adhesion_rest_length"])
    angle = float(p["inheritance_angle_deg"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pos = _lattice_ball(cells, spacing, cfg["jitter"], gen, device)
    pairs = _neighbor_bonds(pos, spacing)
    while True:
        d0 = _unit(pos[pairs[:, 1]] - pos[pairs[:, 0]])
        kept = _prune(pairs, pos, _classify(d0, angle),
                      _classify(-d0, angle))
        if len(kept) == len(pairs):
            break
        pairs = kept
    radius = torch.full((cells,), float(p["max_radius"]), device=device)
    volume = (4.0 / 3.0) * math.pi * radius ** 3
    mass = p["density"] * volume
    inertia = 0.4 * mass * radius ** 2
    drag = 0.5 + 0.5 * torch.rand(cells, generator=gen, device=device)
    ia, ib = pairs[:, 0], pairs[:, 1]
    dirs = _unit(pos[ib] - pos[ia])
    nb = len(pairs)
    R = float(torch.linalg.vector_norm(pos, dim=-1).max())
    return {
        "pos": pos, "radius": radius, "mass": mass, "inertia": inertia,
        "drag": drag, "ia": ia, "ib": ib,
        "zone_a": _classify(dirs, angle), "zone_b": _classify(-dirs, angle),
        "anchor_a": dirs, "anchor_b": -dirs,
        "spawn_radius": R + 2.0 * spacing,
        "max_bonds": -(-int(nb * 1.05 + 64) // 8192) * 8192,
    }
