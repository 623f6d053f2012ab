"""Kernel-vs-plain checks on the live card — the counterpart of
sph_tpu.utils.verify.check_fluid_twins. Each check runs a hand-written
kernel and its plain PyTorch version on the same CUDA tensors and raises
AssertionError on disagreement.

Contract: the pair sweeps (K1, K2) agree to the JAX twin tolerance,
rtol 1e-5 and atol 1e-6·max|x|, on occupied slots (empty slots are garbage
in the plain version); their checks also report `bitwise` (every
occupied slot's bits equal the plain version's) and `empty_zero` (every
empty slot of the result holds +0), which the kernels give by design and
chip_smoke.py asserts on the card; the rebin (K3) is bitwise on all 7
payload fields (with −0 == +0) and on `dropped`. The colony contact sweep
(K4) agrees to the twin tolerance on EVERY slot of its 6 components, for
finite fields (csrc/contact_sweep.cu states what its skip hides from
non-finite ones), and reports `bitwise` and `empty_zero` as K1/K2 do; the
contact pack's placement (K5) is bitwise on all 11 planes, −0 included.
`expand_lookup` is K5's row lookup and `rebin_codes` / `rebin_walk` are
K3's two passes, written out in plain PyTorch for the CPU tests;
`empty_layout`, `place_particle`, `moved_layout` and `overflow_layout`
build the rebin's test layouts.

The hardware verification lane — the counterpart of the JAX package's
`CHECKS`, `run_all` and `verify_summary`, with `tools/verify_chip.py`'s
CLI as `python -m sph_tpu_torch.utils.verify` — runs JAX's five twin
checks that apply to the port on a device (the card unless asked), each
scene built here from numpy (`blob`) or the port's scenes: the fluid
kernels at k = 8, the contact pack's placement on three blobs, and the
dense contact forces end to end. JAX's two BondPlan checks (planned and
hybrid adhesion) have no counterpart: the port has no BondPlan (ROADMAP A,
"Not ported"), so there is nothing to hold against the plain adhesion.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.ops.contact import contact_sweep
from sph_tpu_torch.ops.expand import RANGE, expand_rows
from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
from sph_tpu_torch.ops.rebin import staged_rebin
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.model import eos_pressure

RTOL = 1e-5
ATOL_REL = 1e-6

REBIN_FIELDS = ("occ", "px", "py", "pz", "vx", "vy", "vz")


def _close_on_occupied(name: str, plain, kern, occ) -> dict:
    m = occ > 0.5
    x, p = plain[m], kern[m]
    scale = float(x.abs().max())
    err = (x - p).abs()
    bound = RTOL * p.abs() + ATOL_REL * scale   # np.testing.assert_allclose
    n_bad = int((err > bound).sum())
    max_err = float(err.max())
    if n_bad:
        raise AssertionError(
            f"{name}: {n_bad} occupied slots outside rtol={RTOL} "
            f"atol={ATOL_REL}*{scale:.4g} (max abs err {max_err:.4g})")
    return {"max_abs_err": max_err, "atol": ATOL_REL * scale, "rtol": RTOL}


def _bits(x) -> torch.Tensor:
    return x.view(torch.int32)


def _exactness(plain, kern, occ) -> dict:
    """`bitwise`: the occupied slots' bits equal; `empty_zero`: every empty
    slot of `kern` is +0."""
    m = occ > 0.5
    return {"bitwise": bool(torch.equal(_bits(plain[m]), _bits(kern[m]))),
            "empty_zero": not bool(_bits(kern[~m]).any())}


def check_density(d, params, spec) -> dict:
    """K1 against dense.density_raw on the state's positions."""
    plain = dense.density_raw(d.px, d.py, d.pz, params, spec)
    kern = density_sweep(d.px, d.py, d.pz, d.occ, params, spec)
    return {**_close_on_occupied("density", plain, kern, d.occ),
            **_exactness(plain, kern, d.occ)}


def accel_inputs(d, params, spec):
    """The state with ρ and p from the plain density pass and a velocity
    field that varies in space (vx = sin 3px, vy = cos 3py on occupied
    slots, as the JAX package's check sets it), so the viscosity terms
    matter even where the fluid is at rest."""
    rho = dense.density_pass(d, params, spec)
    prs = torch.where(d.occ > 0.5, eos_pressure(rho, params), 0.0)
    return d.replace_fields(rho=rho, prs=prs,
                            vx=torch.sin(d.px * 3) * d.occ,
                            vy=torch.cos(d.py * 3) * d.occ)


def check_accel(d, params, spec) -> dict:
    """K2 against dense.accel_raw; `d` must carry consistent ρ and p."""
    pr2 = d.prs / (d.rho * d.rho)
    plain = dense.accel_raw(d, torch.reciprocal(d.rho), pr2, params, spec)
    kern = accel_sweep(d, pr2, params, spec)
    results = [_close_on_occupied(f"accel {axis}", x, p, d.occ)
               for axis, x, p in zip("xyz", plain, kern)]
    if results[0]["atol"] == 0.0:
        raise AssertionError("accel check is vacuous: zero x acceleration")
    exact = [_exactness(x, p, d.occ) for x, p in zip(plain, kern)]
    return {**max(results, key=lambda r: r["max_abs_err"]),
            **{k: all(e[k] for e in exact) for k in exact[0]}}


def nudge(d, spec, params, seed: int = 0):
    """Positions moved by a random ±0.27-cell scatter plus a pull toward
    the domain centre clamped to 0.9 cell per axis, so destination cells
    crowd past K and the rebin's overflow path runs (the nudge of the JAX
    package's rebin tests)."""
    g = torch.Generator(device=d.px.device).manual_seed(seed)
    lim = 0.9 * spec.cell
    delta = (torch.rand((3, *d.px.shape), generator=g, device=d.px.device)
             * 2.0 - 1.0) * lim
    out = []
    for a, p in enumerate((d.px, d.py, d.pz)):
        ctr = (params.bounds_min[a] + params.bounds_max[a]) / 2
        pull = torch.clamp(ctr - p, -lim, lim)
        out.append(torch.where(d.occ > 0.5, p + 0.3 * delta[a] + pull, p))
    return out


def check_rebin(d, params, spec, seed: int = 0) -> dict:
    """K3 (both passes) against dense.rebin on nudged positions:
    bitwise on every field, equal `dropped`, and `dropped > 0`."""
    px, py, pz = nudge(d, spec, params, seed)
    args = (px, py, pz, d.vx, d.vy, d.vz, params, spec)
    a = dense.rebin(d, *args)
    b = staged_rebin(d, *args)
    max_err = 0.0
    for f in REBIN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        n_diff = int((x != y).sum())
        if n_diff:
            raise AssertionError(f"rebin {f}: {n_diff} slots differ")
        max_err = max(max_err, float((x - y).abs().max()))
    da, db = int(a.dropped - d.dropped), int(b.dropped - d.dropped)
    if da != db:
        raise AssertionError(f"rebin dropped: plain {da} != kernel {db}")
    if da <= 0:
        raise AssertionError("rebin nudge dropped nothing: overflow path "
                             "not exercised")
    return {"max_abs_err": max_err, "dropped": da}


def check_fluid_twins(d, params, spec, seed: int = 0) -> dict:
    """All three kernels against their plain versions on state `d` (CUDA
    tensors). Returns {kernel: result}; raises on any disagreement."""
    return {
        "density": check_density(d, params, spec),
        "accel": check_accel(accel_inputs(d, params, spec), params, spec),
        "rebin": check_rebin(d, params, spec, seed),
    }


# -- the colony contact path (K4, K5) --------------------------------------


def _close_everywhere(name: str, plain, kern) -> dict:
    scale = float(plain.abs().max())
    err = (plain - kern).abs()
    bound = RTOL * kern.abs() + ATOL_REL * scale
    n_bad = int((err > bound).sum())
    max_err = float(err.max())
    if n_bad:
        raise AssertionError(
            f"{name}: {n_bad} slots outside rtol={RTOL} "
            f"atol={ATOL_REL}*{scale:.4g} (max abs err {max_err:.4g})")
    return {"max_abs_err": max_err, "atol": ATOL_REL * scale, "rtol": RTOL,
            "bitwise": bool(torch.equal(plain.view(torch.int32),
                                        kern.view(torch.int32)))}


def check_contact(state, params, spec) -> dict:
    """K4 against the plain sweep on the state's packed fields, every slot
    of all 6 components (`empty_zero`: every empty slot of the kernel's
    result is +0); also counts the slots with a nonzero force
    (`contact_slots`)."""
    fields, occ, _, _ = cd._pack_args(state, spec)
    return check_contact_fields(fields, occ, params, spec)


def check_contact_fields(fields, occ, params, spec) -> dict:
    """check_contact on packed planes (a whole pack, or the halo-padded
    block of one rank, parallel.dist.contact_block)."""
    plain = cd._sweep_plain(
        fields, lambda *a: cd.contact_pair_terms(params, *a), 6, spec)
    kern = contact_sweep(fields, occ, params, spec)
    results = [_close_everywhere(f"contact {c}", a, b)
               for c, a, b in zip(("fx", "fy", "fz", "tx", "ty", "tz"),
                                  plain, kern)]
    out = max(results, key=lambda r: r["max_abs_err"])
    out["bitwise"] = all(r["bitwise"] for r in results)
    empty = occ <= 0.5
    out["empty_zero"] = not any(bool(_bits(k[empty]).any()) for k in kern)
    force = torch.stack(plain[:3])
    out["contact_slots"] = int((force != 0).any(dim=0).sum())
    return out


def check_expand(state, spec) -> dict:
    """K5 against the plain `_scatter_sorted` on the state's pack sort:
    bitwise on all 11 planes (compared as int32 bits, so −0 ≠ +0). Also
    reports the rows placed, the overflow and the dead rows."""
    rows, flat, fits, key, overflow, _ = cd._sort_with_payload(state, spec)
    kern = expand_rows(rows, key, cd.PACK_FILLS, spec)
    plain = cd._scatter_sorted(rows.unbind(1), cd.PACK_FILLS, flat, fits,
                               spec)
    n_diff = 0
    for c, p in enumerate(plain):
        n_diff += int((kern[c].view(torch.int32)
                       != p.reshape(-1).view(torch.int32)).sum())
    if n_diff:
        raise AssertionError(f"expand: {n_diff} slots differ in their bits")
    return {"max_abs_err": 0.0, "rows": int(fits.sum()),
            "overflow": int(overflow),
            "dead": int((key >= spec.slots).sum())}


def expand_lookup(key, slots: int, range_slots: int = RANGE):
    """K5's row lookup (csrc/expand_rows.cu) in plain PyTorch, step for
    step: the start table (start[r] = the first row whose key ≥
    r·range_slots, for r up to the number of ranges; row i fills the
    entries (range(key[i − 1]), range(key[i])]), then per range its rows
    [start[r], start[r + 1]) that fit — key in the range and unlike the
    row before's. Returns (slot → row [slots] int64, −1 where the fill
    stays; the start table). Refuses a key that is not nondecreasing, as
    `flat` is once a cell overflows: no search can find a range's rows by
    it."""
    k = key.long()
    n = k.numel()
    if n > 1 and bool((k[1:] < k[:-1]).any()):
        raise ValueError("expand_lookup: the key is not nondecreasing, so "
                         "it cannot locate a range's rows (is it `flat`?)")
    ranges = -(-slots // range_slots)
    cur = torch.cat([torch.clamp(k // range_slots, max=ranges),
                     torch.tensor([ranges])])
    prev = torch.cat([torch.tensor([-1]), cur[:-1]])
    start = torch.repeat_interleave(torch.arange(n + 1), cur - prev)
    slot_row = torch.full((slots,), -1, dtype=torch.int64)
    for r in range(ranges):
        s0 = r * range_slots
        span = min(range_slots, slots - s0)
        i = torch.arange(int(start[r]), int(start[r + 1]))
        ki = k[i]
        before = torch.where(i > 0, k[torch.clamp(i - 1, min=0)], -1)
        fit = (ki >= s0) & (ki - s0 < span) & (ki != before)
        slot_row[ki[fit]] = i[fit]
    return slot_row, start


def rebin_codes(px, py, pz, occ, spec) -> torch.Tensor:
    """K3's first pass (csrc/rebin.cu) in plain PyTorch: one code per slot
    of the [Z, K, C] layout (int32), 0 where the slot is empty, else
    0x40 | ez << 4 | ey << 2 | ex, where e is the move along that layout
    axis (the bin coordinate of `dense.bin_coord` minus the cell's own)
    plus 1, or 3 when the move is more than one cell; without a plane
    stage (2D) ez is 1 (no move)."""
    Z, _, C = px.shape
    dev = px.device
    iota_c = torch.arange(C, device=dev)
    own = (torch.arange(Z, device=dev).view(Z, 1, 1),
           torch.div(iota_c, spec.X, rounding_mode="floor").view(1, 1, C),
           (iota_c % spec.X).view(1, 1, C))
    dims = (spec.n0, spec.n1, spec.n2)
    pos = (px, py, pz)
    code = torch.full(px.shape, 0x40, dtype=torch.int32, device=dev)
    for dim, shift in ((2, 0), (1, 2), (0, 4)):
        e = torch.ones_like(code)
        if dim > 0 or spec.stencil0:
            wa = spec.axis_map[dim]
            move = dense.bin_coord(pos[wa], spec.origin[wa], spec.cell,
                                   dims[dim]) - own[dim]
            e = torch.where(move.abs() <= 1, move + 1, 3).to(torch.int32)
        code |= e << shift
    return torch.where(occ > 0.5, code, 0)


def rebin_walk(d, px, py, pz, vx, vy, vz, params, spec):
    """K3's second pass (csrc/rebin.cu) in plain PyTorch, step for step and
    vectorised over the cells: each cell walks its 27 source cells
    (planes a, rows b, in-row c, by fused index, empty outside the array),
    then each source slot, with the three counters r2 / r1 / r0 and the
    drop owners the kernel's note sets out, and takes the payload of each
    placed slot by copy. A drop-in for `dense.rebin`; never on the main
    path."""
    Z, K, C = px.shape
    X = spec.X
    dev = px.device
    codes = rebin_codes(px, py, pz, d.occ, spec)
    flat = torch.arange(Z * K * C, device=dev).view(Z, K, C)
    pads = (X + 1, X + 1, 0, 0, 1, 1)
    codes_p = torch.nn.functional.pad(codes, pads)
    flat_p = torch.nn.functional.pad(flat, pads, value=-1)
    src = torch.full((Z, K, C), -1, dtype=torch.int64, device=dev)
    zeros = torch.zeros((Z, C), dtype=torch.int64, device=dev)
    r0 = zeros.clone()
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    zi, ci = torch.meshgrid(torch.arange(Z, device=dev),
                            torch.arange(C, device=dev), indexing="ij")
    for a in ((-1, 0, 1) if spec.stencil0 else (0,)):
        r1 = zeros.clone()
        for b in (-1, 0, 1):
            r2 = zeros.clone()
            for c in (-1, 0, 1):
                o = X + 1 + b * X + c
                nb_codes = codes_p[1 + a:1 + a + Z, :, o:o + C]
                nb_flat = flat_p[1 + a:1 + a + Z, :, o:o + C]
                for k in range(K):
                    code = nb_codes[:, k]
                    ex, ey, ez = code & 3, (code >> 2) & 3, (code >> 4) & 3
                    m = code != 0
                    if (a, b, c) == (0, 0, 0):
                        drops += (m & (ex == 3)).sum()
                    m = m & (ex == 1 - c)
                    if a == 0 and b == 0:
                        drops += (m & (r2 >= K)).sum()
                    m = m & (r2 < K)
                    r2 += m
                    if a == 0 and b == 0:
                        drops += (m & (ey == 3)).sum()
                    m = m & (ey == 1 - b)
                    if a == 0:
                        drops += (m & (r1 >= K)).sum()
                    m = m & (r1 < K)
                    r1 += m
                    if spec.stencil0:
                        if a == 0:
                            drops += (m & (ez == 3)).sum()
                        m = m & (ez == 1 - a)
                        drops += (m & (r0 >= K)).sum()
                        m = m & (r0 < K)
                    src[zi[m], r0[m], ci[m]] = nb_flat[:, k][m]
                    r0 += m
    placed = src >= 0
    take = src.clamp(min=0)

    def gather(f, fill):
        return torch.where(placed, f.reshape(-1)[take], fill)

    return d.replace_fields(
        px=gather(px, dense.SENTINEL), py=gather(py, dense.SENTINEL),
        pz=gather(pz, dense.SENTINEL), vx=gather(vx, 0.0),
        vy=gather(vy, 0.0), vz=gather(vz, 0.0), occ=placed.to(torch.float32),
        dropped=d.dropped + drops.to(torch.int32))


def empty_layout(spec) -> dict:
    """Numpy fields px, py, pz, vx, vy, vz, occ of an empty `spec` layout
    (sentinel positions, zeros elsewhere)."""
    shape = (spec.n0, spec.k, spec.C)
    out = {f: np.full(shape, dense.SENTINEL, np.float32)
           for f in ("px", "py", "pz")}
    out.update({f: np.zeros(shape, np.float32)
                for f in ("vx", "vy", "vz", "occ")})
    return out


def place_particle(lay, spec, slot, src, dst, rng) -> None:
    """Put a particle in `slot` of layout cell `src` (z, r, x) at a random
    point of layout cell `dst` (coordinates may leave the array: bin_coord
    clips them), with a normal velocity."""
    z, r, x = src
    j = (z, slot, r * spec.X + x)
    for dim, cell in enumerate(dst):
        wa = spec.axis_map[dim]
        u = rng.uniform(0.1, 0.9)
        lay[("px", "py", "pz")[wa]][j] = np.float32(
            spec.origin[wa] + (cell + u) * spec.cell)
    for f in ("vx", "vy", "vz"):
        lay[f][j] = np.float32(rng.normal())
    lay["occ"][j] = 1.0


def moved_layout(spec, seed: int, reach: int = 2, fill: float = 0.6) -> dict:
    """A layout on `spec` drawn with numpy from `seed` (numpy arrays px, py,
    pz, vx, vy, vz, occ): each slot of each interior cell holds a particle
    with probability `fill` (slots left empty between them), moved by
    whole cells in {−reach..reach} on every axis with a rebin stage, so
    that "far" moves and crowded cells both occur."""
    rng = np.random.default_rng(seed)
    lay = empty_layout(spec)
    dims = (spec.n0, spec.n1, spec.n2)
    staged = (spec.stencil0, True, True)
    ranges = [range(1, n - 1) if on else range(n)
              for n, on in zip(dims, staged)]
    for z in ranges[0]:
        for r in ranges[1]:
            for x in ranges[2]:
                for slot in range(spec.k):
                    if rng.uniform() >= fill:
                        continue
                    move = [int(rng.integers(-reach, reach + 1)) if on else 0
                            for on in staged]
                    dst = (z + move[0], r + move[1], x + move[2])
                    place_particle(lay, spec, slot, (z, r, x), dst, rng)
    return lay


def overflow_layout(spec, stage: int, seed: int = 0) -> tuple[dict, tuple]:
    """The case a one-stage shortcut gets wrong: a particle dropped at an
    intermediate stage though its final cell has room. Stage 2: K
    particles in (z, r+1, x−1) move to (z, r+1, x) and fill it in stage 2
    before the own particle of (z, r+1, x), bound for (z, r, x), comes.
    Stage 1: K particles in (z+1, r−1, x) move to (z+1, r, x) and fill it
    in stage 1 before the particle of (z+1, r, x) bound for (z, r, x).
    Returns (layout, its (z, r, x)), whose cell must end empty, with one
    particle dropped."""
    rng = np.random.default_rng(seed)
    lay = empty_layout(spec)
    z = spec.n0 // 2 if spec.stencil0 else 0
    r, x = spec.n1 // 2, spec.n2 // 2
    if stage == 2:
        fillers, mover = (z, r + 1, x - 1), (z, r + 1, x)
        fill_dst = (z, r + 1, x)
    elif stage == 1 and spec.stencil0:
        fillers, mover = (z + 1, r - 1, x), (z + 1, r, x)
        fill_dst = (z + 1, r, x)
    else:
        raise ValueError(f"overflow_layout: no stage {stage} on this spec")
    for slot in range(spec.k):
        place_particle(lay, spec, slot, fillers, fill_dst, rng)
    place_particle(lay, spec, 0, mover, (z, r, x), rng)
    return lay, (z, r, x)


def compressed(state, factor: float):
    """The state with live positions scaled by `factor` about their
    centroid, so neighbours move inside the contact reach."""
    n = int(state.active_count)
    pos = state.pos.clone()
    c = pos[:n].mean(dim=0)
    pos[:n] = c + (pos[:n] - c) * factor
    return state.replace_fields(pos=pos)


def blob(n: int = 400, k: int = 4, seed: int = 3, radius: float = 9.0,
         spawn: float = 10.0, alive: int | None = None,
         radii=(1.6, 2.0), device="cuda"):
    """n cells in a ball of `radius` (cube-root radial law), moving and
    spinning (normal velocity and spin × 0.5), radii uniform in `radii`,
    the first `alive` of them live, drawn with numpy from `seed`: the
    expand probe's scene (tools/repro_expand.py: n = 400, k = 4, spawn 10,
    radii 2.0) and its variants. Returns (state, params, contact spec)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = radius * rng.uniform(size=(n, 1)) ** (1 / 3)
    p = SimParams(capacity=n, spawn_radius=spawn, neighbor_mode="dense",
                  dense_k=k)
    f32 = dict(dtype=torch.float32, device=device)
    state = SimState.zeros(n, p, device=device).replace_fields(
        pos=torch.tensor(u * r, **f32),
        vel=torch.tensor(rng.normal(size=(n, 3)) * 0.5, **f32),
        ang_vel=torch.tensor(rng.normal(size=(n, 3)) * 0.5, **f32),
        radius=torch.tensor(rng.uniform(*radii, n), **f32),
        active_count=torch.tensor(n if alive is None else alive,
                                  dtype=torch.int32, device=device))
    spec = cd.make_contact_spec(p, k=k, cell_factor=p.dense_cell_factor)
    return state, p, spec



# -- the hardware verification lane ----------------------------------------


def check_fluid_scene(n_target: int = 3000, k: int = 8,
                      cell_factor: float = 1.2, device="cuda") -> dict:
    """JAX's `check_fluid_twins` scene: dam_break_3d at `n_target`
    particles packed at `k` and `cell_factor`; K1, K2 and K3 against their
    plain versions (`check_fluid_twins`)."""
    from sph_tpu_torch.sph.scenes import dam_break_3d

    state, params = dam_break_3d(n_target=n_target)
    params = params.replace(dense_k=k, cell_factor=cell_factor)
    spec = dense.make_dense_spec(params, k=k, cell_factor=cell_factor)
    d = dense.pack(state, params, spec, device=device)
    return check_fluid_twins(d, params, spec)


def check_expand_pack(n: int, k: int, seed: int = 3, spread: float = 9.0,
                      device="cuda") -> dict:
    """K5 against the plain placement, bitwise on all 11 planes, on JAX's
    bench-verify blob: n cells of radius 2 within `spread` (smaller is
    denser: more cell overflow), spawn radius 10."""
    state, _, spec = blob(n=n, k=k, seed=seed, radius=spread, spawn=10.0,
                          radii=(2.0, 2.0), device=device)
    return check_expand(state, spec)


def check_contact_end2end(n: int = 400, k: int = 4, seed: int = 3,
                          device="cuda") -> dict:
    """`contact_forces_dense` through the kernels (K5 and K4) against the
    plain path, force and torque at the twin tolerance, on the blob of
    `check_expand_pack`; the scene must have contact."""
    state, params, _ = blob(n=n, k=k, seed=seed, radius=9.0, spawn=10.0,
                            radii=(2.0, 2.0), device=device)
    fx, tx, _ = cd.contact_forces_dense(
        state, dataclasses.replace(params, use_pallas=False))
    fp, tp, _ = cd.contact_forces_dense(
        state, dataclasses.replace(params, use_pallas=True))
    if float(fx.abs().max()) == 0.0:
        raise AssertionError("degenerate scene: zero contact force")
    return {"force": _close_everywhere(f"contact force n={n} k={k}", fx, fp),
            "torque": _close_everywhere(f"contact torque n={n} k={k}", tx,
                                        tp)}


# (name, check on a device): JAX's lane less its BondPlan checks, under
# JAX's names. The expand-pack scenes ride three densities: the round-3
# repro (a sparse blob with one overflow), a crushed blob (heavy overflow)
# and colony-like k = 2 occupancy.
CHECKS = (
    ("fluid twins (density/accel/rebin, k=8)",
     lambda device: check_fluid_scene(k=8, device=device)),
    ("expand pack blob n=400 k=4 (round-3 repro)",
     lambda device: check_expand_pack(400, 4, device=device)),
    ("expand pack crushed n=1200 k=4",
     lambda device: check_expand_pack(1200, 4, seed=5, spread=4.0,
                                      device=device)),
    ("expand pack colony-k n=2048 k=2",
     lambda device: check_expand_pack(2048, 2, seed=7, spread=14.0,
                                      device=device)),
    ("contact end-to-end n=400 k=4",
     lambda device: check_contact_end2end(device=device)),
)


def run_all(verbose: bool = False, device="cuda"):
    """Run every check on `device`. Returns a list of (name, None | error
    string)."""
    results = []
    for name, fn in CHECKS:
        try:
            fn(device)
            err = None
        except AssertionError as e:
            # numpy's assertion messages start with a newline: keep the
            # first two non-empty lines.
            lines = [ln.strip() for ln in str(e).split("\n") if ln.strip()]
            err = " | ".join(lines[:2])[:200] or repr(e)[:200]
        if verbose:
            print(f"  {'ok  ' if err is None else 'FAIL'} {name}"
                  + (f": {err}" if err else ""), flush=True)
        results.append((name, err))
    return results


def verify_summary(device="cuda") -> str:
    """'ok (<device type>, <n> twin checks)' or 'FAIL: <first failure>'."""
    results = run_all(device=device)
    fails = [(n, e) for n, e in results if e is not None]
    if fails:
        return f"FAIL: {fails[0][0]}: {fails[0][1]}"
    return (f"ok ({torch.device(device).type}, {len(results)} twin "
            f"checks)")


def main(argv=None) -> int:
    """The lane's CLI: every check on the card (or `--device cpu`), one
    line each; exits 1 on any failure."""
    ap = argparse.ArgumentParser(
        prog="python -m sph_tpu_torch.utils.verify",
        description="Hold every hand-written kernel to its plain version "
                    "on the live card.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' "
                         "wrappers run their plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (pass --device cpu for the plain route)",
                  file=sys.stderr)
            return 1
        where = torch.cuda.get_device_name(device)
    else:
        where = "cpu"
    print(f"device: {where}  torch {torch.__version__}", flush=True)
    results = run_all(verbose=True, device=device)
    fails = [(n, e) for n, e in results if e is not None]
    print(f"{len(results) - len(fails)}/{len(results)} twin checks ok")
    for n, e in fails:
        print(f"FAIL {n}: {e}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
