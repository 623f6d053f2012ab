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
contact pack's placement (K5) is bitwise on all 11 planes, −0 included;
the pack's slot bookkeeping (the slots kernel) is bitwise on its five
outputs (`check_contact_slots`; `slot_case` draws the edge cases) and the
gather back (the gather kernel) on every particle's force and torque, NaN
and −0 bits included (`check_contact_gather`).
The adhesion pass's per-bond rows (A1) are bitwise on every row of the
table, NaN as NaN and −0 ≠ +0 (`check_bond_rows`; `bond_edge_cases` loads
every constraint and plants the edge cases). The planned accumulate (A2)
is bitwise on every particle's Δv and Δq (`check_bond_scan`;
`bond_scan_case` draws a random plan with −0, NaN and ±inf rows;
`END_PLANS` / `end_plan` are hand-made plans for rows of −0).
`expand_lookup` is K5's row lookup (with `expand_search`),
`rank_lookback` the slots kernel's rank rule, and
`rebin_codes` / `rebin_walk` are K3's two passes, written out in plain
PyTorch for the CPU tests;
`empty_layout`, `place_particle`, `moved_layout` and `overflow_layout`
build the rebin's test layouts.

The hardware verification lane — the counterpart of the JAX package's
`CHECKS`, `run_all` and `verify_summary`, with `tools/verify_chip.py`'s
CLI as `python -m sph_tpu_torch.utils.verify` — runs JAX's seven twin
checks on a device (the card unless asked), each scene built here from
numpy (`blob`) or the port's scenes: the fluid kernels at k = 8, the
contact pack's placement on three blobs, the dense contact forces end to
end, and the planned adhesion accumulate against the plain one over 8
colony steps, settled and through a division window.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.ops import adhesion as oa
from sph_tpu_torch.ops import contact_slots as ocs
from sph_tpu_torch.ops.contact import contact_sweep
from sph_tpu_torch.ops.expand import RANGE, expand_rows
from sph_tpu_torch.ops import integrate as oi
from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
from sph_tpu_torch.ops.rebin import staged_rebin
from sph_tpu_torch.physics import adhesion as adh
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.model import eos_pressure

RTOL = 1e-5
ATOL_REL = 1e-6

REBIN_FIELDS = ("occ", "px", "py", "pz", "vx", "vy", "vz", "rho", "prs")


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


# -- the step's per-slot tail (F1, F2) --------------------------------------

INTEGRATE_FIELDS = ("px", "py", "pz", "vx", "vy", "vz")
TAIL_FIELDS = ("rho", "prs", "pr2")


def same_bits(plain, kern) -> torch.Tensor:
    """Per slot: equal bits (−0 ≠ +0), or NaN in both."""
    return ((_bits(plain) == _bits(kern))
            | (plain.isnan() & kern.isnan()))


def _bitwise(names, plain, kern) -> dict:
    """`bitwise` over every slot of each plane (NaN as NaN), the slots
    that differ a plane, and the largest |difference| (0 where the bits
    agree; inf where only one side is NaN)."""
    differ, err = {}, 0.0
    for name, a, b in zip(names, plain, kern):
        same = same_bits(a, b)
        differ[name] = int((~same).sum())
        if differ[name]:
            gap = (a - b).abs().nan_to_num(nan=float("inf"))
            err = max(err, float(torch.where(same, 0.0, gap).max()))
    return {"bitwise": not any(differ.values()), "max_abs_err": err,
            "differ": differ}


def tail_inputs(d, params, spec):
    """The inputs of the step's tail on state `d`, from the step's own
    passes (kernels on the card, plain versions on the CPU): K1's raw ρ,
    the state with ρ and p from it, and K2's accelerations."""
    raw = density_sweep(d.px, d.py, d.pz, d.occ, params, spec)
    rho, prs, pr2 = dense.density_tail(raw, d.occ, params)
    d = d.replace_fields(rho=rho, prs=prs)
    return raw, d, accel_sweep(d, pr2, params, spec)


def stirred(d, acc, params, vmax: float, seed: int = 0, nan: bool = False):
    """Accelerations with every 7th slot given a random kick of up to
    2·vmax/dt per axis, so the vmax clamp and the walls fire; with `nan`,
    three occupied slots also get a NaN acceleration, a NaN position and
    a +inf velocity. Returns (state, (ax, ay, az))."""
    g = torch.Generator(device=d.px.device).manual_seed(seed)
    scale = 2.0 * vmax / params.dt
    mask = torch.zeros(d.px.numel(), dtype=torch.bool, device=d.px.device)
    mask[::7] = True
    mask = mask.view(d.px.shape)
    out = []
    for a in acc:
        r = torch.rand(a.shape, generator=g, device=a.device) * 2.0 - 1.0
        out.append(torch.where(mask, a + scale * r, a))
    if nan:
        slots = torch.nonzero((d.occ > 0.5).reshape(-1))[:, 0]
        picks = slots[torch.tensor([0, slots.numel() // 2, -1],
                                   device=slots.device)].tolist()
        px, vy = d.px.clone(), d.vy.clone()
        out[0].view(-1)[picks[0]] = float("nan")
        px.view(-1)[picks[1]] = float("nan")
        vy.view(-1)[picks[2]] = float("inf")
        d = d.replace_fields(px=px, vy=vy)
    return d, tuple(out)


def check_integrate(d, ax, ay, az, params, vmax: float, drag=None) -> dict:
    """F1 against dense._integrate on the same tensors: the six moved
    planes on every slot (`bitwise`, NaN as NaN), the clamp counts and the
    obstacles' push counts."""
    plain = dense._integrate(d, ax, ay, az, params, vmax, drag=drag)
    kern = oi.integrate(d, ax, ay, az, params, vmax, drag=drag)
    out = _bitwise(INTEGRATE_FIELDS, plain[:6], kern[:6])
    for i, name in ((6, "n_clamped"), (7, "n_pushed")):
        out[name] = int(kern[i])
        out["plain_" + name] = int(plain[i])
        out["bitwise"] = out["bitwise"] and out[name] == out["plain_" + name]
    out["nan_slots"] = sum(int(k.isnan().sum()) for k in kern[:6])
    return out


def check_density_tail(raw, occ, params) -> dict:
    """F2 against dense.density_tail: ρ, p and p/ρ² on every slot
    (`bitwise`, NaN as NaN)."""
    return _bitwise(TAIL_FIELDS, dense.density_tail(raw, occ, params),
                    oi.density_tail(raw, occ, params))


# -- the adhesion pass's per-bond rows (A1) ---------------------------------

BOND_ROW_COLUMNS = ("dv_x", "dv_y", "dv_z", "dq_x", "dq_y", "dq_z", "dq_w")


def check_bond_rows(state, params, genome, dt=None) -> dict:
    """A1 against the plain adhesion.bond_rows on the same state: every
    row of the [Mp, 7] table (`bitwise`, NaN as NaN), and the rows with a
    nonzero delta (`loaded`), which show that the constraints fired."""
    plain = adh.bond_rows(state, params, genome, dt)
    kern = oa.bond_rows(state, params, genome, dt)
    out = _bitwise(BOND_ROW_COLUMNS, plain.unbind(1), kern.unbind(1))
    out["rows"] = int(kern.shape[0])
    out["loaded"] = {"dv": int((kern[:, :3] != 0).any(1).sum()),
                     "dq": int((kern[:, 3:] != 0).any(1).sum())}
    return out


def bond_edge_cases(state, seed: int = 0, nan: bool = True):
    """The state with every constraint loaded — velocities kicked and
    rotations turned, so springs, anchor swings and the orientation
    correction fire — and the edge cases planted among its active bonds:
    slot_a −1 on every 11th, slot_b −1 on every 13th, every 17th
    inactive, every 19th with both endpoints on one cell; with `nan`, one
    endpoint's position, another's velocity and a third's rotation NaN."""
    dev = state.pos.device
    g = torch.Generator(device=dev).manual_seed(seed)
    vel = state.vel + 0.5 * torch.randn(state.vel.shape, generator=g,
                                        device=dev)
    rot = state.rot + 0.2 * torch.randn(state.rot.shape, generator=g,
                                        device=dev)
    rot = rot / rot.norm(dim=1, keepdim=True)
    b = state.bonds
    live = torch.nonzero(b.active)[:, 0]
    slot_a, slot_b = b.slot_a.clone(), b.slot_b.clone()
    active = b.active.clone()
    slot_a[live[::11]] = -1
    slot_b[live[::13]] = -1
    active[live[::17]] = False
    slot_b[live[5::19]] = slot_a[live[5::19]]
    pos = state.pos.clone()
    if nan:
        ends = slot_a[live[1:4]].long()
        pos[ends[0]] = float("nan")
        vel[ends[1], 1] = float("nan")
        rot[ends[2], 2] = float("nan")
    return state.replace_fields(
        pos=pos, vel=vel, rot=rot,
        bonds=b.replace_fields(slot_a=slot_a, slot_b=slot_b, active=active))


# -- the planned accumulate (A2) --------------------------------------------


def bond_scan_case(n_cells: int, n_bonds: int, seed: int = 0,
                   active: float = 0.7, special: bool = False,
                   device="cpu"):
    """A random bond table of `n_bonds` bonds over `n_cells` cells (each
    bond active with probability `active`, slot_a −1 on some), its
    BondPlan built on `device`, a [Mp, 7] row table of normal deltas with
    5% −0 entries, and a zero_bond mask of ~2% of the bonds (the hybrid's
    changed bonds). With `special`, NaN, +inf and −inf entries and a whole
    NaN row planted in valid bonds' rows. Drawn on the CPU from `seed`, so
    every device gets the same case. Returns (bonds, plan, rows,
    zero_bond)."""
    from sph_tpu_torch.core.types import BondTable

    g = torch.Generator().manual_seed(seed)
    slot_a = torch.randint(-1, n_cells, (n_bonds,), generator=g,
                           dtype=torch.int32)
    slot_b = torch.randint(0, n_cells, (n_bonds,), generator=g,
                           dtype=torch.int32)
    live = torch.rand(n_bonds, generator=g) < active
    bonds = BondTable.empty(n_bonds, device="cpu").replace_fields(
        slot_a=slot_a, slot_b=slot_b, active=live)
    mp = adh.padded_rows(n_bonds)
    rows = torch.randn((mp, 7), generator=g)
    rows[torch.rand((mp, 7), generator=g) < 0.05] = -0.0
    ok = torch.nonzero(live & (slot_a >= 0))[:, 0]
    if special and ok.numel():
        # Rows of valid bonds (A side, B side), so the values reach a run.
        picks = ok[torch.randint(0, ok.numel(), (4,), generator=g)]
        rows[picks[0], 0] = float("nan")
        rows[picks[1] + n_bonds, 3] = float("inf")
        rows[picks[2], 5] = float("-inf")
        rows[picks[3] + n_bonds] = float("nan")
    zero_bond = torch.rand(n_bonds, generator=g) < 0.02
    bonds = bonds.replace_fields(**{
        f.name: getattr(bonds, f.name).to(device)
        for f in dataclasses.fields(bonds)})
    plan = adh.build_bond_plan(bonds, n_cells)
    return bonds, plan, rows.to(device), zero_bond.to(device)


# Hand-made plans over 4,096 rows in order, a particle a run, for rows of
# −0 alone: name: (the rows that end a run, the last ending the drop run;
# whether row 0 starts a run). Their runs end at block offsets 2^k − 1,
# where an in-block sum of −0s stays −0. Without a start at row 0 (the
# plain scan's identity, which no BondPlan has) the totals' pads and the
# first block's +0 prefix are added too.
END_PLANS = {
    "all -0, run ends at 2^k - 1": ((1535, 2303, 3199, 3583, 4095), True),
    "all -0, no first start": ((1535, 2303, 3199, 3583, 4095), False),
    "all -0, no first start, an end in block 0":
        ((511, 1535, 2303, 4095), False),
}


def end_plan(name: str, device="cpu"):
    """The BondPlan of END_PLANS[name] (its snapshot empty)."""
    from sph_tpu_torch.core.types import BondTable

    ends, first_start = END_PLANS[name]
    mp = ends[-1] + 1
    flags = torch.zeros(mp, dtype=torch.bool)
    flags[0] = first_start
    flags[torch.tensor(ends[:-1]) + 1] = True
    b = BondTable.empty(0, device="cpu")
    plan = adh.BondPlan(
        perm=torch.arange(mp), flags=flags, last=torch.tensor(ends[:-1]),
        has=torch.ones(len(ends) - 1, dtype=torch.bool), snap_a=b.slot_a,
        snap_b=b.slot_b, snap_active=b.active)
    return plan.replace_fields(**{
        f.name: getattr(plan, f.name).to(device)
        for f in dataclasses.fields(plan)})


def check_bond_scan(rows, plan, zero_bond=None) -> dict:
    """A2 against the plain accumulate_bond_deltas_planned on the same
    tensors: every particle's Δv and Δq (`bitwise`, NaN as NaN;
    `same_bits`, NaN payloads too)."""
    plain = torch.cat(adh.accumulate_bond_deltas_planned(rows, plan,
                                                         zero_bond), 1)
    kern = torch.cat(oa.bond_scan(rows, plan, zero_bond), 1)
    out = _bitwise(BOND_ROW_COLUMNS, plain.unbind(1), kern.unbind(1))
    out["same_bits"] = torch.equal(_bits(plain), _bits(kern))
    out["rows"] = int(rows.shape[0])
    out["blocks"] = int(rows.shape[0]) // adh._SEG_W
    out["particles"] = int(plan.has.shape[0])
    out["with_bonds"] = int(plan.has.sum())
    out["nan_particles"] = int(kern.isnan().any(1).sum())
    return out


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


SLOT_OUTPUTS = ("flat", "fits", "key", "overflow", "slot_of")


def check_contact_slots(cid_s, order, spec) -> dict:
    """The slots kernel against the plain `_rank_and_slots` on the same
    sorted cell ids and order: each of the five outputs of the same dtype
    and shape and equal element for element. Also reports the rows, those
    that fit, the overflow and the dead rows."""
    plain = cd._rank_and_slots(cid_s, order, spec)
    kern = ocs.rank_and_slots(cid_s, order, spec)
    for name, a, b in zip(SLOT_OUTPUTS, plain, kern):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"contact slots {name}: {b.dtype} "
                                 f"{tuple(b.shape)}, plain {a.dtype} "
                                 f"{tuple(a.shape)}")
        if not torch.equal(a, b):
            raise AssertionError(f"contact slots {name}: "
                                 f"{int((a != b).sum())} elements differ")
    dead = spec.nz * spec.ny * spec.nx_pad
    return {"rows": cid_s.numel(), "fits": int(plain[1].sum()),
            "overflow": int(plain[3]), "dead": int((cid_s >= dead).sum())}


def check_contact_gather(comps_flat, slot_of, overflow) -> dict:
    """The gather kernel against the plain `gather_back` on the same six
    planes: force and torque of every particle compared as int32 bits (NaN
    payloads and −0 included), the overflow passed through. Also reports
    the particles, those dropped (slot_of = slots) and the NaN rows."""
    slots = comps_flat[0].numel()
    plain = cd.gather_back(comps_flat, slot_of, overflow)
    kern = ocs.gather_back(comps_flat, slot_of, overflow)
    for name, a, b in zip(("force", "torque"), plain, kern):
        if a.shape != b.shape or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"contact gather {name}: "
                                 f"{int((_bits(a) != _bits(b)).sum())} "
                                 f"elements differ in their bits")
    if kern[2] is not overflow:
        raise AssertionError("contact gather: the overflow is not passed "
                             "through")
    return {"particles": slot_of.numel(),
            "dropped": int((slot_of == slots).sum()),
            "nan_rows": int(plain[0].isnan().any(1).sum()
                            + plain[1].isnan().any(1).sum())}


def rank_lookback(cid_s, order, spec):
    """The slots kernel (csrc/contact_slots.cu) in plain PyTorch: each row
    looks back at most K ids for the run of equal ids it ends, which gives
    min(rank, K), all the outputs need; then the five outputs of
    `_rank_and_slots` in int32 arithmetic."""
    n, k, slots = cid_s.numel(), spec.k, spec.slots
    r = torch.zeros(n, dtype=torch.int32, device=cid_s.device)
    run = torch.ones(n, dtype=torch.bool, device=cid_s.device)
    for d in range(1, k + 1):
        same = torch.zeros_like(run)
        same[d:] = cid_s[d:] == cid_s[:-d]
        run &= same
        r += run.to(torch.int32)
    alive = cid_s < spec.nz * spec.ny * spec.nx_pad
    fits = alive & (r < k)
    flat = torch.where(fits, cid_s * k + r, slots).to(torch.int32)
    key = (cid_s * k + torch.clamp(r, max=k - 1)).to(torch.int32)
    overflow = torch.sum(alive & ~fits).to(torch.int32)
    slot_of = torch.empty_like(flat)
    slot_of[order] = flat
    return flat, fits, key, overflow, slot_of


SLOT_CASES = ("runs past K", "every row dead", "one cell", "one row",
              "odd rows")


def slot_case(spec, case: str, seed: int = 0, n: int = 5000,
              device="cpu"):
    """Sorted cell ids [n] int32 and the stable sort's order [n] int64 of
    ids drawn with numpy from `seed`, shuffled, for the slots kernel's
    edge cases: `runs past K`, runs of 1 to 3K + 2 rows in random live
    cells and a tenth of the rows dead (the dead id nz·ny·nx_pad);
    `every row dead`; `one cell`, every row in one live cell; `one row`, a
    single live row (n is 1); `odd rows`, n + 37 rows (not a multiple of a
    block) in runs of 1 to K + 1."""
    rng = np.random.default_rng(seed)
    dead = spec.nz * spec.ny * spec.nx_pad
    k = spec.k
    if case == "every row dead":
        ids = np.full(n, dead)
    elif case == "one cell":
        ids = np.full(n, rng.integers(dead))
    elif case == "one row":
        ids = rng.integers(dead, size=1)
    elif case in ("runs past K", "odd rows"):
        total = n + 37 if case == "odd rows" else n
        longest = 3 * k + 2 if case == "runs past K" else k + 1
        lengths = rng.integers(1, longest + 1, size=total)
        lengths = lengths[:np.searchsorted(np.cumsum(lengths), total) + 1]
        cells = rng.choice(dead, size=lengths.size,
                           replace=lengths.size > dead)
        ids = np.repeat(cells, lengths)[:total]
        if case == "runs past K":
            ids[rng.random(total) < 0.1] = dead
    else:
        raise ValueError(f"no slot case {case!r}")
    cid = torch.tensor(rng.permutation(ids), dtype=torch.int32,
                       device=device)
    return torch.sort(cid, stable=True)


EXPAND_THREADS = 256   # kThreads in csrc/expand_rows.cu: a batch, a search


def expand_search(key, target: int) -> tuple[int, int]:
    """K5's block search (csrc/expand_rows.cu `first_at_least`) step for
    step: EXPAND_THREADS threads probe the splitters lo + ⌊span·(j + 1) /
    (EXPAND_THREADS + 1)⌋ of the window [lo, hi), count those whose key is
    below `target` and narrow the window to the piece that holds the
    answer, until it holds at most EXPAND_THREADS rows; then one probe of
    them all. Returns (the first row whose key is ≥ target, n if none;
    the rounds of probes, the last one included)."""
    n = key.numel()
    lanes = torch.arange(EXPAND_THREADS)
    split = EXPAND_THREADS + 1
    lo, hi, rounds = 0, n, 1
    while hi - lo > EXPAND_THREADS:
        span = hi - lo
        f = int((key[lo + span * (lanes + 1) // split] < target).sum())
        lo0 = lo
        if f > 0:
            lo = lo0 + span * f // split + 1
        if f < EXPAND_THREADS:
            hi = lo0 + span * (f + 1) // split
        rounds += 1
    p = (lo + lanes)[lo + lanes < hi]
    return lo + int((key[p] < target).sum()), rounds


def expand_lookup(key, slots: int, chunk: int, range_slots: int = RANGE):
    """K5's row lookup (csrc/expand_rows.cu) in plain PyTorch, step for
    step: block b takes ranges [b·chunk, (b + 1)·chunk) of `range_slots`
    slots, finds its first range's first row by `expand_search`, and
    carries the row cursor from range to range: per range it reads
    EXPAND_THREADS keys from the cursor at a time, places the rows that
    fit (key in the range and unlike the row before's), moves the cursor
    past the rows whose key is below the range's end, and ends the range
    at a batch that is not all such rows. Returns (slot → row [slots]
    int64, −1 where the fill stays; the cursor at each range's start and,
    last, at the end: ranges + 1 rows). Refuses a key that is not
    nondecreasing, as `flat` is once a cell overflows: no search can find
    a range's rows by it."""
    k = key.long()
    n = k.numel()
    if n > 1 and bool((k[1:] < k[:-1]).any()):
        raise ValueError("expand_lookup: the key is not nondecreasing, so "
                         "it cannot locate a range's rows (is it `flat`?)")
    past = 2 ** 31 - 1                     # INT_MAX: no key past the rows
    k_ext = torch.cat([k, torch.tensor([past])])
    ranges = -(-slots // range_slots)
    start = torch.full((ranges + 1,), -1, dtype=torch.int64)
    slot_row = torch.full((slots,), -1, dtype=torch.int64)
    lanes = torch.arange(EXPAND_THREADS)
    for r_begin in range(0, ranges, chunk):
        cursor = expand_search(k, r_begin * range_slots)[0]
        for r in range(r_begin, min(r_begin + chunk, ranges)):
            start[r] = cursor
            s0 = r * range_slots
            span, s1 = min(range_slots, slots - s0), s0 + range_slots
            while True:
                i = cursor + lanes
                ki = k_ext[torch.clamp(i, max=n)]
                before = k_ext[torch.clamp(i - 1, min=0, max=n)]
                fit = ((i < n) & (ki >= s0) & (ki - s0 < span)
                       & ((i == 0) | (ki != before)))
                slot_row[ki[fit]] = i[fit]
                taken = int((ki < s1).sum())
                cursor += taken
                if taken < EXPAND_THREADS:
                    break
        if r_begin + chunk >= ranges:
            start[ranges] = cursor   # the last block's cursor at the end
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
    placed slot (position, velocity, ρ, p) by copy. A drop-in for
    `dense.rebin`; never on the main path."""
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
        vy=gather(vy, 0.0), vz=gather(vz, 0.0),
        rho=gather(d.rho, params.rest_density), prs=gather(d.prs, 0.0),
        occ=placed.to(torch.float32),
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


def _held(name: str, plain, planned, rtol: float, atol: float) -> None:
    np.testing.assert_allclose(planned.cpu().numpy(), plain.cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=name)


def check_planned_adhesion(n: int = 4096, device="cuda") -> None:
    """The planned adhesion accumulate (a frozen sort and the segmented
    scan) against the plain one over 8 steps of the n-cell bonded colony
    (dense, k = 2, through the kernels): velocities within JAX's rtol
    1e-4, atol 1e-5; quaternions within rtol 1e-4, atol 1e-4, the
    tolerance of JAX's own planned-vs-plain test of the same steps
    (tests/test_adhesion.py) and of the port's quaternions
    (tests/test_torch_simulation.py). JAX's check holds the quaternions
    at atol 1e-5, which its own run on the CPU misses: the
    relative-orientation constraint's correction axis is rounding noise
    on a settled bond, so the sums' reassociation grows about 2.5× a step
    there (ROADMAP §C)."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.step import run_steps

    st, params, genome = bonded_colony(n, device=device, dense_k=2,
                                       neighbor_mode="dense",
                                       use_pallas=True)
    gd = genome.to_device(device)
    a = run_steps(st, dataclasses.replace(params, adhesion_plan="off"), gd,
                  8)
    b = run_steps(st, dataclasses.replace(params, adhesion_plan="on"), gd,
                  8)
    nb = int(a.active_count)
    _held("planned adhesion vel", a.vel[:nb], b.vel[:nb], 1e-4, 1e-5)
    _held("planned adhesion rot", a.rot[:nb], b.rot[:nb], 1e-4, 1e-4)


def check_hybrid_adhesion_division(n: int = 2048, device="cuda") -> None:
    """The hybrid stale-plan accumulate through a division window (the
    n-cell colony resized to n + 64, 16 split timers armed to fire in the
    8 steps, so the plan's snapshot goes stale and the changed bonds ride
    the side table) against the plain accumulate: 16 splits in both, bond
    topology bitwise, velocities within rtol 1e-4, atol 1e-4."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.engine.step import run_steps

    st, params, genome = bonded_colony(n, device=device, dense_k=2,
                                       neighbor_mode="dense",
                                       use_pallas=True,
                                       max_splits_per_step=32)
    sim = Simulation(genome, params, auto_grow=False, donate=False,
                     device=device)
    sim.state = st
    sim.resize(n + 64)
    pp, gd = sim.params, sim.genome_dev
    timer = sim.state.split_timer.clone()
    timer[:16] = float(gd.split_interval[0]) - 3 * pp.dt
    st = sim.state.replace_fields(split_timer=timer)
    a = run_steps(st, dataclasses.replace(pp, adhesion_plan="off"), gd, 8)
    b = run_steps(st, dataclasses.replace(pp, adhesion_plan="on"), gd, 8)
    na, nb = int(a.active_count), int(b.active_count)
    if not na == n + 16 == nb:
        raise AssertionError(f"hybrid adhesion splits: {na}, {nb} cells, "
                             f"expected {n + 16}")
    _held("hybrid adhesion vel (division)", a.vel[:na], b.vel[:na], 1e-4,
          1e-4)
    np.testing.assert_array_equal(
        b.bonds.active.cpu().numpy(), a.bonds.active.cpu().numpy(),
        err_msg="hybrid adhesion bond topology")


# (name, check on a device): JAX's lane under JAX's names. The expand-pack
# scenes ride three densities: the round-3 repro (a sparse blob with one
# overflow), a crushed blob (heavy overflow) and colony-like k = 2
# occupancy.
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
    ("planned adhesion n=4096",
     lambda device: check_planned_adhesion(device=device)),
    ("hybrid adhesion through division n=2048",
     lambda device: check_hybrid_adhesion_division(device=device)),
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
