"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips on a host without a
CUDA device; this file imports no JAX, so on the card it runs without the
repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 are held to rtol 1e-5, atol 1e-6·max|x| on occupied
slots (sph_tpu_torch.utils.verify) and, by their design (the plain
version's summation order, no FMA contraction, a screen that skips only
exact ±0 terms), to bitwise equality on occupied slots — NaN where the
plain version is NaN — and +0 on empty ones; K3 is bitwise (−0 == +0,
`dropped` equal), also on random layouts with moves of up to two cells and
on overflows at an intermediate stage, at each K it is built for. K4 (colony
contact sweep) is held to the same tolerance on every slot and, by the
same design, to bitwise equality with +0 on empty slots, and its floor
modes (ops/contact_floor.py) bitwise to their plain versions; K5 (the
contact pack's placement) is bitwise. K1, K2 and K4 are held so on the
halo-padded blocks of a sharded step too (a ring's [P + 2]-plane slabs, a 2D mesh's
local rows). The render (plain PyTorch) is held to itself
twice on the card bitwise and to the CPU's render of the same state within
atol 1e-4 (the z-buffer, a minimum, exactly); the app's `fluid` command
must launch the sweeps once a step and the rebin twice a rebin."""

import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch.core.types import state_to_numpy
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.ops import FLOOR_LAUNCHES, LAUNCHES, reset_launches
from sph_tpu_torch.ops import contact as oc
from sph_tpu_torch.ops import contact_floor as cf
from sph_tpu_torch.ops.contact import contact_sweep
from sph_tpu_torch.ops.expand import expand_rows
from sph_tpu_torch.ops.fluid import accel_sweep, band_plan, density_sweep
from sph_tpu_torch.ops.rebin import staged_rebin
from sph_tpu_torch.parallel import dist as pd
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.scenes import dam_break_2d, dam_break_3d
from sph_tpu_torch.utils.verify import (
    accel_inputs,
    blob,
    check_contact,
    check_expand,
    check_fluid_twins,
    compressed,
    empty_layout,
    moved_layout,
    overflow_layout,
    place_particle,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SCENES = {
    "3d": ("dam_break_3d_obstacle", dict(n_target=20000, cell_factor=1.38,
                                         dense_k=8, rebin_every=6)),
    "2d": ("dam_break_2d", dict(n_target=4096, dense_k=4, cell_factor=1.2,
                                rebin_every=3)),
}
COLONY = dict(neighbor_mode="dense", max_splits_per_step=64, dense_k=2,
              use_pallas=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def exact(kern, plain, occ):
    """Occupied slots: the plain version's bits, NaN for NaN; empty: +0."""
    m = occ > 0.5
    a, b = kern[m], plain[m]
    nan = b.isnan()
    assert torch.equal(a.isnan(), nan)
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))
    assert not bool(kern[~m].view(torch.int32).any())


def sweeps_exact(d, d2, p, spec):
    """K1 on d's positions and K2 on d2 (positions and the accel inputs)
    against their plain versions; returns the number of NaN results."""
    rho = density_sweep(d.px, d.py, d.pz, d.occ, p, spec)
    exact(rho, dense.density_raw(d.px, d.py, d.pz, p, spec), d.occ)
    pr2 = d2.prs / (d2.rho * d2.rho)
    plain = dense.accel_raw(d2, torch.reciprocal(d2.rho), pr2, p, spec)
    kern = accel_sweep(d2, pr2, p, spec)
    for a, b in zip(kern, plain):
        exact(a, b, d2.occ)
    return int(rho.isnan().sum()) + sum(int(a.isnan().sum()) for a in kern)


def stepped(cuda, case, steps=12):
    scene, kw = SCENES[case]
    sim = FluidSimulation.from_scene(scene, substeps=6, device=cuda, **kw)
    sim.run(steps)
    return sim.dstate, sim.params, sim.spec


@pytest.mark.parametrize("case", sorted(SCENES))
def test_kernels_match_plain(cuda, case):
    d, p, spec = stepped(cuda, case)
    r = check_fluid_twins(d, p, spec, seed=3)
    assert r["rebin"]["dropped"] > 0
    for name in ("density", "accel"):
        assert r[name]["bitwise"] and r[name]["empty_zero"], r[name]
        assert r[name]["max_abs_err"] == 0.0
    assert sweeps_exact(d, accel_inputs(d, p, spec), p, spec) == 0


# Where a cell's slots run out (or are added): positions at the sentinel,
# everything else 0 (ρ and p are recomputed by accel_inputs).
EMPTY_SLOT = {"px": dense.SENTINEL, "py": dense.SENTINEL,
              "pz": dense.SENTINEL, "vx": 0.0, "vy": 0.0, "vz": 0.0,
              "occ": 0.0, "rho": 0.0, "prs": 0.0}


@pytest.mark.parametrize("case,k", [("3d", 4), ("2d", 8)])
def test_sweeps_exact_in_the_other_builds(cuda, case, k):
    """The other two builds of the sweeps — K = 4 with a plane stencil,
    K = 8 without — on a stepped scene cut to its first 4 slots per cell
    (3D) or given 4 more, empty ones (2D)."""
    d, p, built = stepped(cuda, case, steps=6)

    def reslot(x, fill):
        if k <= built.k:
            return x[:, :k].contiguous()
        pad = torch.full((built.n0, k - built.k, built.C), fill,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=1)

    spec = dataclasses.replace(built, k=k)
    d = d.replace_fields(**{f: reslot(getattr(d, f), fill)
                            for f, fill in EMPTY_SLOT.items()})
    assert tuple(d.px.shape) == (spec.n0, k, spec.C)
    assert bool((d.occ > 0.5).any())
    assert sweeps_exact(d, accel_inputs(d, p, spec), p, spec) == 0


def test_sweeps_exact_in_a_full_cell(cuda):
    """Every slot of one cell occupied: the same-cell group A and its
    mirror lump run over all K − 1 partners."""
    d, p, spec = stepped(cuda, "3d")
    occ = d.occ > 0.5
    live = torch.nonzero(occ)
    z, k, c = (int(i) for i in live[len(live) // 2])
    g = torch.Generator(device=cuda).manual_seed(5)
    jitter = (torch.rand((3, spec.k), generator=g, device=cuda) - 0.5) \
        * (0.5 * p.h)
    fields = {f: getattr(d, f).clone() for f in ("px", "py", "pz", "occ")}
    for a, f in enumerate(("px", "py", "pz")):
        fields[f][z, :, c] = getattr(d, f)[z, k, c] + jitter[a]
    fields["occ"][z, :, c] = 1.0
    d = d.replace_fields(**fields)
    assert bool((d.occ > 0.5).all(dim=1).any())
    assert sweeps_exact(d, accel_inputs(d, p, spec), p, spec) == 0


@pytest.mark.parametrize("case", sorted(SCENES))
def test_sweeps_exact_beside_an_empty_band(cuda, case):
    """An occupied band next to one emptied by hand: the gate skips the
    empty band (its outputs +0) and the sweep stages it as a halo."""
    d, p, spec = stepped(cuda, case)
    plan = band_plan(spec)
    occ = d.occ > 0.5
    z = int(torch.nonzero(occ)[0, 0])
    rows = occ[z].any(dim=0).view(spec.n1, spec.X).any(dim=1)
    live = [b for b in range(plan.bands - 1)
            if rows[b * plan.rows:(b + 1) * plan.rows].any()
            and rows[(b + 1) * plan.rows:(b + 2) * plan.rows].any()]
    b = live[len(live) // 2] + 1
    cut = slice(b * plan.rows * spec.X, min((b + 1) * plan.rows, spec.n1)
                * spec.X)
    fields = {f: getattr(d, f).clone() for f in
              ("px", "py", "pz", "vx", "vy", "vz", "occ")}
    for f in ("px", "py", "pz"):
        fields[f][z, :, cut] = dense.SENTINEL
    for f in ("vx", "vy", "vz", "occ"):
        fields[f][z, :, cut] = 0.0
    d = d.replace_fields(**fields)
    assert not bool((d.occ[z, :, cut] > 0.5).any())
    assert bool((d.occ[z, :, (b - 1) * plan.rows * spec.X:cut.start]
                 > 0.5).any())
    assert sweeps_exact(d, accel_inputs(d, p, spec), p, spec) == 0


def test_sweeps_keep_nan_positions(cuda):
    """A NaN position makes NaN pair terms, which neither screen skips:
    K1 and K2 are NaN exactly where the plain versions are (the accel
    inputs come from the finite state, so only the position is NaN)."""
    d, p, spec = stepped(cuda, "3d")
    d2 = accel_inputs(d, p, spec)
    z, k, c = (int(i) for i in torch.nonzero(d.occ > 0.5)[100])
    px = d.px.clone()
    px[z, k, c] = float("nan")
    assert sweeps_exact(d.replace_fields(px=px), d2.replace_fields(px=px),
                        p, spec) > 1


# The blocks that ranks of a sharded step sweep (parallel.dist): halo-padded
# slabs of P + 2 planes, and over a 2D mesh the local rows plus 2·8 rows of
# halo and sentinel filler (a spec of its own).
MESHES = (((4,), (0,)), ((4,), (1,)), ((2, 2), (0, 0)), ((2, 2), (0, 1)))


@pytest.mark.parametrize("shape,coords", MESHES)
def test_sweeps_exact_on_halo_padded_blocks(cuda, shape, coords):
    d, p, spec = stepped(cuda, "3d")
    slab, sspec = pd.fluid_slab(d, p, spec, shape, coords)
    planes, rows = pd.blocks(spec, shape)
    assert slab.px.shape[0] == planes + 2 and sspec.C == slab.px.shape[2]
    assert int(slab.occ.sum()) > 0
    assert sweeps_exact(slab, accel_inputs(slab, p, sspec), p, sspec) == 0


@pytest.mark.parametrize("shape,coords", MESHES)
def test_contact_kernel_exact_on_halo_padded_blocks(cuda, shape, coords):
    """On a crowded ball of cells (many contacts), K = 2 as the colony."""
    state, params, spec = blob(n=2000, k=2, radius=14.0, spawn=16.0,
                               device=cuda)
    fields, occ, _, _ = cd._pack_args(state, spec, expand=True)
    block, sspec = pd.contact_block([*fields, occ], spec, shape, coords)
    f_s, occ_s = block[:10], block[10]
    assert occ_s.shape == sspec.shape()
    assert occ_s.shape[0] == -(-spec.nz // shape[0]) + 2
    assert contact_exact(f_s, occ_s, params, sspec) > 0


def test_main_path_launches_kernels(cuda):
    scene, kw = SCENES["3d"]
    sim = FluidSimulation.from_scene(scene, substeps=6, device=cuda, **kw)
    n0 = sim.metrics()["n_particles"]
    reset_launches()
    sim.run(12)
    torch.cuda.synchronize()
    # 2 rebins, each a codes and a placement launch.
    assert LAUNCHES == {"density": 12, "accel": 12, "rebin": 4,
                        "contact": 0, "expand": 0}
    m = sim.metrics()
    assert m["n_particles"] == n0 and m["dropped"] == 0


def test_kernel_path_equals_plain_path(cuda):
    """With bitwise kernels the whole trajectory is bitwise too."""
    scene, kw = SCENES["2d"]
    sims = [FluidSimulation.from_scene(scene, substeps=6, device=cuda,
                                       use_pallas=flag, **kw)
            for flag in (True, False)]
    for s in sims:
        s.run(30)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs",
              "dropped", "clamped"):
        assert torch.equal(getattr(sims[0].dstate, f),
                           getattr(sims[1].dstate, f)), f


def small_spec(name):
    """Params and spec of a small scene ("3d8": 3D at K = 8, "2d4": 2D at
    K = 4, ...), for layouts built cell by cell."""
    scene = dam_break_3d if name.startswith("3d") else dam_break_2d
    _, p = scene(n_target=1000 if scene is dam_break_3d else 300,
                 cell_factor=1.2)
    return p, dense.make_dense_spec(p, k=int(name[2:]), cell_factor=1.2)


def layout_state(lay, cuda):
    t = {f: torch.from_numpy(a).to(cuda) for f, a in lay.items()}
    zeros = torch.zeros_like(t["occ"])
    i32 = torch.zeros((), dtype=torch.int32, device=cuda)
    return dense.DenseFluidState(**t, rho=zeros, prs=zeros, dropped=i32,
                                 clamped=i32, step_count=i32)


def rebin_equal(d, p, spec):
    """K3 against dense.rebin on d's own fields: equal values on all 7
    fields (−0 == +0); returns (plain dropped, kernel dropped)."""
    args = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, p, spec)
    a, b = dense.rebin(d, *args), staged_rebin(d, *args)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    return int(a.dropped), int(b.dropped)


@pytest.mark.parametrize("name", ["3d8", "3d4", "2d4", "2d8"])
def test_rebin_kernel_on_far_moves_and_intermediate_overflow(cuda, name):
    """K3 at each K and stage set it is built for, on random layouts with
    moves of up to two cells (far codes, crowded cells, slots left empty
    between occupied ones) and on the overflows at an intermediate stage
    that a one-stage move would miss."""
    p, spec = small_spec(name)
    stages = (2, 1) if spec.stencil0 else (2,)
    lays = [moved_layout(spec, seed) for seed in (0, 1)]
    lays += [overflow_layout(spec, stage)[0] for stage in stages]
    for lay in lays:
        plain, kern = rebin_equal(layout_state(lay, cuda), p, spec)
        assert plain == kern > 0


def test_rebin_kernel_on_an_empty_layout(cuda):
    """No particle at all: every block skips its walk and writes the fill."""
    p, spec = small_spec("3d8")
    assert rebin_equal(layout_state(empty_layout(spec), cuda), p,
                       spec) == (0, 0)


def test_rebin_kernel_keeps_nan_and_inf_positions(cuda):
    """ROADMAP C1: NaN and ±inf coordinates. K3 clamps with fmaxf/fminf
    (NaN → lo), the plain rebin converts NaN to 0 before its clamp: both
    bin as JAX does, and both copy a non-finite coordinate into its own
    slot only. Equal bits on every field (NaN as NaN: the card's
    arithmetic gives its canonical NaN where K3 copies the input's; −0 ==
    +0) and equal `dropped` (the two ±inf particles move far: 2)."""
    p, spec = small_spec("3d8")
    lay = empty_layout(spec)
    rng = np.random.default_rng(0)
    for cell in ((1, 1, 1), (2, 2, 2), (5, 5, 5), (6, 6, 6)):
        place_particle(lay, spec, 0, cell, cell, rng)
    X = spec.X
    lay["px"][1, 0, X + 1] = np.nan
    lay["py"][5, 0, 5 * X + 5] = np.inf
    lay["pz"][6, 0, 6 * X + 6] = -np.inf
    d = layout_state(lay, cuda)
    args = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, p, spec)
    a, b = dense.rebin(d, *args), staged_rebin(d, *args)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ"):
        x, y = getattr(a, f), getattr(b, f)
        same = ((x.view(torch.int32) == y.view(torch.int32))
                | (x.isnan() & y.isnan()) | ((x == 0) & (y == 0)))
        assert bool(same.all()), f
    assert int(a.dropped) == int(b.dropped) == 2
    assert int(a.px.isnan().sum()) == 1 and int(a.occ.sum()) == 2


def test_wrappers_refuse_bad_operands(cuda):
    scene, kw = SCENES["2d"]
    sim = FluidSimulation.from_scene(scene, device=cuda, **kw)
    d, p, spec = sim.dstate, sim.params, sim.spec
    with pytest.raises(TypeError, match="float32"):
        density_sweep(d.px.double(), d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="contiguous"):
        t = d.px.transpose(1, 2).contiguous().transpose(1, 2)
        density_sweep(t, d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="shape"):
        density_sweep(d.px[:, :2], d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="CUDA"):
        density_sweep(d.px, d.py.cpu(), d.pz, d.occ, p, spec)
    args = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, p)
    with pytest.raises(ValueError, match="K in"):
        staged_rebin(d, *args, dataclasses.replace(spec, k=6))
    with pytest.raises(ValueError, match="CUDA"):
        staged_rebin(d, d.px, d.py.cpu(), *args[2:], spec)


def colony(cuda, n=20000):
    state, params, genome = bonded_colony(n, device=cuda, **COLONY)
    spec = cd.make_contact_spec(params, k=params.dense_k,
                                cell_factor=params.dense_cell_factor)
    return state, params, genome, spec


def test_contact_and_expand_kernels_match_plain(cuda):
    state, params, _, spec = colony(cuda)
    settled = check_contact(state, params, spec)
    squeezed = check_contact(compressed(state, 0.7), params, spec)
    assert squeezed["contact_slots"] > 0
    assert settled["bitwise"] and squeezed["bitwise"]
    assert check_expand(state, spec)["rows"] == 20000


def contact_exact(fields, occ, params, spec):
    """K4 against the plain sweep: the plain bits on every slot, and +0 on
    the empty ones. Returns the number of slots with a nonzero force."""
    plain = cd._sweep_plain(
        fields, lambda *a: cd.contact_pair_terms(params, *a), 6, spec)
    kern = contact_sweep(fields, occ, params, spec)
    empty = occ <= 0.5
    for a, b in zip(kern, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert not bool(a[empty].view(torch.int32).any())
    return int((torch.stack(plain[:3]) != 0).any(dim=0).sum())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_contact_kernel_bitwise_at_each_k(cuda, k):
    """K4 at each K it is built for, on a crowded ball of cells (many
    contacts)."""
    state, params, spec = blob(n=2000, k=k, radius=14.0, spawn=16.0,
                               device=cuda)
    fields, occ, _, _ = cd._pack_args(state, spec)
    assert contact_exact(fields, occ, params, spec) > 100


def emptied_band(fields, occ, spec):
    """The pack with one band of the busiest plane, between two occupied
    bands, emptied by hand (its fields set to their fills)."""
    plan = oc.band_plan(spec)
    live = (occ > 0.5).any(dim=2)                              # [Z, Y]
    z = int(live.sum(dim=1).argmax())
    bands = torch.nn.functional.pad(
        live[z], (0, plan.bands * plan.rows - spec.ny)).view(
            plan.bands, plan.rows).any(dim=1)
    b = next(i for i in range(1, plan.bands - 1)
             if bands[i - 1] and bands[i] and bands[i + 1])
    cut = slice(b * plan.rows, (b + 1) * plan.rows)
    fields = [f.clone() for f in fields]
    occ = occ.clone()
    for f, fill in zip(fields, cd.FIELD_FILLS):
        f[z, cut] = fill
    occ[z, cut] = cd.OCC_FILL
    assert bool((occ[z, (b - 1) * plan.rows:cut.start] > 0.5).any())
    return fields, occ


def test_contact_kernel_beside_an_empty_band_and_at_the_edges(cuda):
    """An occupied band next to one emptied by hand (the gate zeroes it,
    the sweep stages it as a halo); then the whole pack rolled to put the
    colony's centre at index 0, so that it straddles every edge — bands at
    the first and last row and plane, lanes that wrap — against the plain
    sweep, which wraps as the kernel does."""
    state, params, _, spec = colony(cuda, n=4000)
    fields, occ = emptied_band(
        *cd._pack_args(compressed(state, 0.7), spec)[:2], spec)
    assert contact_exact(fields, occ, params, spec) > 0
    centre = torch.nonzero(occ > 0.5).float().mean(dim=0)
    shift = tuple(-int(c) for c in centre)
    fields = [torch.roll(f, shift, (0, 1, 2)) for f in fields]
    occ = torch.roll(occ, shift, (0, 1, 2))
    on = occ > 0.5
    assert bool(on[0].any() and on[-1].any() and on[:, 0].any()
                and on[:, -1].any() and on[..., 0].any()
                and on[..., -1].any())
    assert contact_exact(fields, occ, params, spec) > 0


def floor_exact(fields, occ, params, spec, rows=None):
    """K4's floor modes against their plain versions at the band's rows,
    bitwise on all six planes, and "full" against contact_sweep, each
    launched once. Returns the slots where the screen mode's band hit."""
    reset_launches()
    kern = {mode: cf.contact_floor(fields, occ, params, spec, mode,
                                   rows=rows) for mode in cf.MODES}
    assert FLOOR_LAUNCHES == {"zero": 1, "pads": 1, "screen": 1}
    assert LAUNCHES["contact"] == 1
    tile = oc.band_plan(spec).rows if rows is None else rows
    for mode, outs in kern.items():
        plain = (contact_sweep(fields, occ, params, spec) if mode == "full"
                 else cf.PLAIN[mode](fields, occ, params, spec, tile))
        for a, b in zip(outs, plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                mode
    return int((kern["screen"][0] != 0).sum())


@pytest.mark.parametrize("rows", [None, 5])
@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_floor_modes_bitwise_at_each_k(cuda, k, rows):
    """The floor modes at each K the kernel is built for, on a crowded ball
    of cells (bands that hit), at the band plan's rows and at 5 rows (the
    last band of a plane shorter)."""
    state, params, spec = blob(n=2000, k=k, radius=14.0, spawn=16.0,
                               device=cuda)
    fields, occ, _, _ = cd._pack_args(state, spec)
    assert spec.ny % 5
    assert floor_exact(fields, occ, params, spec, rows) > 0


def test_floor_modes_beside_an_empty_band(cuda):
    """The floor modes on the settled colony (no band hits the screen) and
    on the compressed one with a band emptied by hand beside occupied
    ones."""
    state, params, _, spec = colony(cuda, n=4000)
    fields, occ, _, _ = cd._pack_args(state, spec)
    assert floor_exact(fields, occ, params, spec) == 0
    fields, occ = emptied_band(
        *cd._pack_args(compressed(state, 0.7), spec)[:2], spec)
    assert floor_exact(fields, occ, params, spec) > 0


@pytest.mark.parametrize("kw", [
    dict(n=4000, k=2, radius=9.0, alive=3900),     # overflow, dead rows
    dict(n=400, k=4, alive=380),                   # the probe's scene
    dict(n=3000, k=1, radius=4.0, alive=2990),     # ~100 rows a cell
])
def test_expand_kernel_bitwise_with_overflow_and_dead_rows(cuda, kw):
    state, _, spec = blob(device=cuda, **kw)
    r = check_expand(state, spec)
    assert r["overflow"] > 0 and r["dead"] == kw["n"] - kw["alive"]


def test_expand_kernel_with_no_rows(cuda):
    spec = blob(n=8, k=2, device="cpu")[2]
    out = expand_rows(torch.empty((0, 11), device=cuda),
                      torch.empty(0, dtype=torch.int32, device=cuda),
                      cd.PACK_FILLS, spec)
    want = torch.tensor(cd.PACK_FILLS, device=cuda)[:, None].expand(
        11, spec.slots).contiguous()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_contact_kernel_keeps_nan_overlap(cuda):
    """A NaN radius makes NaN overlaps, which the kernel does not skip: on
    occupied slots it equals the plain sweep, NaN for NaN."""
    state, params, _, spec = colony(cuda, n=2000)
    squeezed = compressed(state, 0.7)
    radius = squeezed.radius.clone()
    radius[7] = float("nan")
    fields, occ, _, _ = cd._pack_args(squeezed.replace_fields(radius=radius),
                                      spec)
    plain = cd._sweep_plain(
        fields, lambda *a: cd.contact_pair_terms(params, *a), 6, spec)
    kern = contact_sweep(fields, occ, params, spec)
    m = occ > 0.5
    assert bool(plain[0][m].isnan().any())
    for a, b in zip(kern, plain):
        assert torch.equal(a[m].view(torch.int32).masked_fill(a[m].isnan(), 0),
                           b[m].view(torch.int32).masked_fill(b[m].isnan(), 0))
        assert torch.equal(a[m].isnan(), b[m].isnan())


def test_colony_main_path_launches_kernels(cuda):
    state, params, genome, _ = colony(cuda)
    n_bonds = int(state.bonds.active.sum())
    sim = Simulation(genome, params, device=cuda)
    sim.state = state
    reset_launches()
    sim.step(10)
    torch.cuda.synchronize()
    assert LAUNCHES["contact"] == 10 and LAUNCHES["expand"] == 10
    m = sim.metrics()
    assert m["active_particles"] == 20000 and m["overflow"] == 0
    assert m["bond_count"] <= n_bonds
    assert bool(torch.isfinite(sim.state.pos).all())


def test_colony_kernel_path_equals_plain_path(cuda):
    """With bitwise K4 and K5 the colony trajectory is bitwise too."""
    state, params, genome, _ = colony(cuda, n=4000)
    sims = [Simulation(genome, params.replace(use_pallas=flag), device=cuda)
            for flag in (True, False)]
    for s in sims:
        s.state = state
        s.step(10)
    a, b = (state_to_numpy(s.state) for s in sims)
    for k in a:
        assert (a[k] == b[k]).all(), k


def test_colony_wrappers_refuse_bad_operands(cuda):
    state, params, _, spec = colony(cuda, n=2000)
    fields, occ, _, _ = cd._pack_args(state, spec, expand=True)
    with pytest.raises(TypeError, match="float32"):
        contact_sweep([fields[0].double(), *fields[1:]], occ, params, spec)
    with pytest.raises(ValueError, match="shape"):
        contact_sweep([f[:, :8] for f in fields], occ, params, spec)
    rows, _, _, key, _, _ = cd._sort_with_payload(state, spec)
    with pytest.raises(ValueError, match="int32"):
        expand_rows(rows, key.long(), cd.PACK_FILLS, spec)
    with pytest.raises(ValueError, match="fills"):
        expand_rows(rows, key, cd.PACK_FILLS[:5], spec)


# -- render and app (plain PyTorch on the card; the app launches K1–K5) ----


def test_render_repeats_bitwise_and_matches_cpu(cuda):
    """The splat frame, the z-buffer and the impostor frame rendered twice
    on the card are bitwise equal, and within atol 1e-4 of the CPU's on
    the same state (the z-buffer, a minimum, equal)."""
    from sph_tpu_torch.core.types import state_from_numpy as colony_on
    from sph_tpu_torch.engine.fluid import tank_camera
    from sph_tpu_torch.render import splat
    from sph_tpu_torch.render.overlay import cells_image, default_camera
    from sph_tpu_torch.utils.convert import state_from_numpy

    sim = FluidSimulation.from_scene(SCENES["3d"][0], substeps=6,
                                     device=cuda, **SCENES["3d"][1])
    sim.run(12)
    a, b = sim.render_frame(), sim.render_frame()
    assert torch.equal(a, b)
    host = FluidSimulation.from_scene(SCENES["3d"][0], substeps=6,
                                      device="cpu", **SCENES["3d"][1])
    host.dstate = state_from_numpy(
        {f.name: getattr(sim.dstate, f.name).cpu().numpy()
         for f in dataclasses.fields(sim.dstate)}, device="cpu")
    np.testing.assert_allclose(a.cpu().numpy(), host.render_frame().numpy(),
                               rtol=0, atol=1e-4)
    assert bool(torch.isfinite(a).all()) and float(a.max()) > 0.3
    vp = tank_camera(sim.params).view_params()
    pos, _, _, _, mask = dense.unpack(sim.dstate)
    z1, z2 = (splat.zbuffer(pos, vp, 800, 450, mask=mask) for _ in range(2))
    assert torch.equal(z1, z2)
    hpos, _, _, _, hmask = dense.unpack(host.dstate)
    assert torch.equal(z1.cpu(), splat.zbuffer(hpos, vp, 800, 450,
                                               mask=hmask))

    state, params, genome, _ = colony(cuda, n=4000)
    csim = Simulation(genome, params, device=cuda)
    csim.state = state
    camera = default_camera(csim)
    i1, i2 = cells_image(csim, camera), cells_image(csim, camera)
    assert torch.equal(i1, i2)
    chost = Simulation(genome, params, device="cpu")
    chost.state = colony_on(state_to_numpy(state), device="cpu")
    np.testing.assert_allclose(i1.cpu().numpy(),
                               cells_image(chost, camera).numpy(), rtol=0,
                               atol=1e-4)


def test_app_launches_the_kernels(cuda, tmp_path, capsys):
    from sph_tpu_torch.app.__main__ import main

    reset_launches()
    rc = main(["fluid", "--scene", "dam_break_3d_obstacle", "--n", "20000",
               "--steps", "12", "--substeps", "6", "--render-every", "6",
               "--out", str(tmp_path), "--device", "cuda"])
    assert rc == 0
    assert LAUNCHES["density"] == 12 and LAUNCHES["accel"] == 12
    assert LAUNCHES["rebin"] == 4
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 2 and '"dropped": 0' in lines[-1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_00000.png", "frame_00001.png"]
