"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips on a host without a
CUDA device; this file imports no JAX, so on the card it runs without the
repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 are held to rtol 1e-5, atol 1e-6·max|x| on occupied
slots (sph_tpu_torch.utils.verify) and, by their design (the plain
version's summation order, no FMA contraction, a screen that skips only
exact ±0 terms), to bitwise equality on occupied slots — NaN where the
plain version is NaN — and +0 on empty ones, also where the walk stops at
each partner cell's occupied extent: cells with holes, cells full to K, a
band whose every cell holds one particle and a NaN particle with no
occupied partner, at K = 4 and 16 in 2D and K = 8 and 16 in 3D; K3 is
bitwise (−0 == +0, `dropped` equal), also on random layouts with moves of
up to two cells and on overflows at an intermediate stage, at each K it is
built for. K4 (colony
contact sweep) is held to the same tolerance on every slot and, by the
same design, to bitwise equality with +0 on empty slots, and its floor
modes (ops/contact_floor.py) bitwise to their plain versions; K5 (the
contact pack's placement) is bitwise, and so are the pack's slot
bookkeeping (the slots kernel: every output, on runs longer than K, dead
rows, one full cell, one row and a row count off the block, at each K)
and the gather back (the gather kernel: int32 bits, with dropped rows and
NaN and −0 planes), and the contact forces through all four kernels,
single-device and at the ranks' block shapes. The step's per-slot tail, F2
(density fixup + Tait EOS + p/ρ²) and F1 (`_integrate`), is bitwise on
every slot (NaN as NaN, −0 ≠ +0) with equal clamp counts, for each
obstacle kind, with and without the drag, in 3D and 2D, with NaN lanes,
at sizes that are not a multiple of 4 and off 16-byte alignment. A1 (the
adhesion pass's per-bond rows) is bitwise on every row of its table, with
slots of −1, inactive bonds, coincident and NaN endpoints, the anchor
constraints off and a bond count off its tile, and the accumulates it feeds
end bitwise where the eager rows end. A2 (the planned accumulate) is
bitwise on every particle's Δv and Δq, NaN payloads included, on random
plans, at the benchmark's 1M colony and through the hybrid. K1, K2,
F2, F1 and K4 are held so on the
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
from sph_tpu_torch.ops import (
    FLOOR_LAUNCHES,
    LAUNCHES,
    launch_counts,
    rebin_peak,
    reset_launches,
    reset_rebin_peak,
)
from sph_tpu_torch.ops import contact as oc
from sph_tpu_torch.ops import adhesion as oa
from sph_tpu_torch.ops import contact_slots as ocs
from sph_tpu_torch.ops.adhesion import bond_rows
from sph_tpu_torch.ops import contact_floor as cf
from sph_tpu_torch.ops.contact import contact_sweep
from sph_tpu_torch.ops.expand import expand_rows
from sph_tpu_torch.ops.fluid import accel_sweep, band_plan, density_sweep
from sph_tpu_torch.ops.integrate import density_tail, integrate
from sph_tpu_torch.ops.rebin import staged_rebin
from sph_tpu_torch.parallel import dist as pd
from sph_tpu_torch.physics import adhesion as adh
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.scenes import dam_break_2d, dam_break_3d
from sph_tpu_torch.utils.verify import (
    accel_inputs,
    blob,
    END_PLANS,
    bond_edge_cases,
    bond_scan_case,
    check_bond_rows,
    check_bond_scan,
    check_contact,
    check_contact_gather,
    check_contact_slots,
    check_expand,
    check_density_tail,
    check_fluid_twins,
    check_integrate,
    compressed,
    empty_layout,
    end_plan,
    moved_layout,
    overflow_layout,
    place_particle,
    slot_case,
    SLOT_CASES,
    stirred,
    tail_inputs,
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


# config[3] at 16 slots a cell: the bench's cell and cadence (1.38 h, a
# rebin every 6 steps), the layout of the benchmark's collapse cell (1.3 h,
# every 5 steps) and the port's config[3] layout, which the impact cell
# runs (1.3 h, every 2 steps).
CONFIG3_K16 = {"1.38": ((1.38, 6), (145, 16, 7680, 80)),
               "1.3": ((1.3, 5), (154, 16, 7680, 80)),
               "1.3-2": ((1.3, 2), (154, 16, 7680, 80))}


@pytest.fixture(scope="module", params=sorted(CONFIG3_K16))
def config3_k16(request):
    """config[3] stepped 12 steps on the card at K = 16 and a layout of
    CONFIG3_K16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (cf, every), shape = CONFIG3_K16[request.param]
    sim = FluidSimulation.from_scene(
        "dam_break_3d_obstacle", n_target=1_000_000, substeps=6,
        device=torch.device("cuda", 0), dense_k=16, cell_factor=cf,
        rebin_every=every)
    sim.run(12)
    assert int(sim.dstate.dropped) == 0
    spec = sim.spec
    assert (spec.n0, spec.k, spec.C, spec.X) == shape
    return sim.dstate, sim.params, spec


def test_fluid_kernels_bitwise_at_k16_config3(config3_k16):
    """K1 and K2 bitwise on occupied slots and +0 on empty ones, K3 bitwise
    with equal `dropped` > 0 (under the crowding nudge) and equal demand
    peaks, at config[3]'s shapes with 16 slots a cell."""
    d, p, spec = config3_k16
    r = check_fluid_twins(d, p, spec, seed=3)
    assert r["rebin"]["dropped"] > 0
    for name in ("density", "accel"):
        assert r[name]["bitwise"] and r[name]["empty_zero"], r[name]
        assert r[name]["max_abs_err"] == 0.0
    assert sweeps_exact(d, accel_inputs(d, p, spec), p, spec) == 0
    assert rebin_equal(d, p, spec) == (0, 0)


def test_tail_kernels_bitwise_at_k16_config3(config3_k16):
    """F2 and F1 bitwise on every slot of [145, 16, 7680], with the clamp
    and the walls firing, with and without the drag."""
    d, p, spec = config3_k16
    assert tail_exact(d, p, spec) > 0
    assert tail_exact(d, p, spec, drag=a_drag(d, d.px.device), seed=1) > 0


@pytest.mark.parametrize("centre", [(1.2, 0.15), (0.3, 0.15)])
def test_push_count_bitwise_at_k16_config3(config3_k16, centre):
    """F1's count of the lanes the obstacle pushes equals the plain
    version's, positions and velocities bitwise, at config[3]'s 16-slot
    layouts: the pillar where config[3] has it (the column has not reached
    it) and moved into the column (thousands of lanes in its band)."""
    d, p, spec = config3_k16
    p = p.replace(obstacles=(("cylinder_z", centre, 0.12),))
    _, d2, acc = tail_inputs(d, p, spec)
    r = check_integrate(d2, *acc, p, dense.rebin_vmax(p, spec))
    assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    assert r["n_pushed"] == r["plain_n_pushed"]
    assert (r["n_pushed"] > 1000) == (centre[0] < 1.0), r["n_pushed"]


def test_snapshot_and_restore_bitwise_on_the_card(cuda):
    """A device snapshot restored gives the same steps again, bitwise, in
    every state tensor and in the push counter, with the pillar in the
    column so that the push acts."""
    from sph_tpu_torch.ops import obstacle_pushed, reset_obstacle_pushed

    _, kw = SCENES["3d"]
    st, p = dam_break_3d(obstacles=(("cylinder_z", (0.3, 0.15), 0.12),),
                         **kw)
    sim = FluidSimulation(st, p, substeps=6, device=cuda)
    sim.run(12)
    snap = sim.snapshot()
    runs = []
    for _ in range(2):
        reset_obstacle_pushed()
        sim.run(18)
        runs.append(({f: getattr(sim.dstate, f).clone() for f in vars(
            sim.dstate)}, int(obstacle_pushed(cuda)), sim._step))
        sim.restore(snap)
    (a, pa, sa), (b, pb, sb) = runs
    assert pa == pb > 0 and sa == sb == 30
    for f in a:
        assert torch.equal(a[f], b[f]), f


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


# The sweeps' builds at each slot count, on small stepped scenes: K = 4
# and K = 16 without a plane stencil (2D), K = 8 and K = 16 with one; the
# 16-slot builds walk each partner cell's slots below its extent.
EXTENT_LAYOUTS = {
    "2d4": SCENES["2d"],
    "2d16": ("dam_break_2d", dict(n_target=4096, dense_k=16, cell_factor=1.2,
                                  rebin_every=3)),
    "3d8": SCENES["3d"],
    "3d16": ("dam_break_3d_obstacle", dict(n_target=20000, cell_factor=1.3,
                                           dense_k=16, rebin_every=2)),
}


def stepped_layout(cuda, layout, steps=12):
    scene, kw = EXTENT_LAYOUTS[layout]
    sim = FluidSimulation.from_scene(scene, substeps=6, device=cuda, **kw)
    sim.run(steps)
    return sim.dstate, sim.params, sim.spec


def cell_extents(d):
    """1 + each cell's highest occupied slot (0 when empty): [n0, C]."""
    k = d.occ.shape[1]
    slots = torch.arange(1, k + 1, device=d.occ.device)[:, None]
    return ((d.occ > 0.5) * slots).amax(dim=1)


def cell_centres(spec, z, c, device):
    """World positions (x, y, z) of the centres of cells (z, c); 0 on the
    world axis that a 2D layout does not have."""
    idx = (z, torch.div(c, spec.X, rounding_mode="floor"), c % spec.X)
    pos = [torch.zeros(len(z), device=device) for _ in range(3)]
    for dim, axis in enumerate(spec.axis_map):
        if axis < spec.ndim:
            pos[axis] = spec.origin[axis] + (idx[dim] + 0.5) * spec.cell
    return pos


def with_slots(d, z, s, c, pos=None):
    """d with slot (z[i], s[i], c[i]) emptied (pos None: the sentinel, no
    velocity) or holding a particle at pos = (x, y, z) at rest."""
    fields = {f: getattr(d, f).clone() for f in EMPTY_SLOT}
    for f, fill in EMPTY_SLOT.items():
        fields[f][z, s, c] = fill
    if pos is not None:
        for f, x in zip(("px", "py", "pz"), pos):
            fields[f][z, s, c] = x
        fields["occ"][z, s, c] = 1.0
    return d.replace_fields(**fields)


@pytest.mark.parametrize("layout", sorted(EXTENT_LAYOUTS))
def test_sweeps_exact_in_a_full_cell(cuda, layout):
    """Every slot of a cell occupied (extent K): the same-cell group A and
    its mirror lump run over all K − 1 partners; one cell, then up to 64."""
    d, p, spec = stepped_layout(cuda, layout)
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
    one = d.replace_fields(**fields)
    assert bool((one.occ > 0.5).all(dim=1).any())
    assert sweeps_exact(one, accel_inputs(one, p, spec), p, spec) == 0
    # Many full cells: each cell's free slots take its first particle,
    # jittered.
    zs, cs = torch.nonzero((cell_extents(d) > 0) & (cell_extents(d) < spec.k),
                           as_tuple=True)
    zs, cs = zs[::5][:64], cs[::5][:64]
    fields = {f: getattr(d, f).clone() for f in ("px", "py", "pz", "occ")}
    for s in range(1, spec.k):
        free = ~occ[zs, s, cs]
        zf, cf = zs[free], cs[free]
        for a, f in enumerate(("px", "py", "pz")):
            shift = (torch.rand(len(zf), generator=g, device=cuda) - 0.5) \
                * (0.5 * p.h) if a < spec.ndim else 0.0
            fields[f][zf, s, cf] = getattr(d, f)[zf, 0, cf] + shift
        fields["occ"][zf, s, cf] = 1.0
    many = d.replace_fields(**fields)
    assert int((cell_extents(many) == spec.k).sum()) >= len(zs) > 8
    assert sweeps_exact(many, accel_inputs(many, p, spec), p, spec) == 0


@pytest.mark.parametrize("case", ["holes", "extent 1"])
@pytest.mark.parametrize("layout", sorted(EXTENT_LAYOUTS))
def test_sweeps_exact_at_the_occupied_extents(cuda, layout, case):
    """The walk stops at each partner cell's occupied extent (1 + its
    highest occupied slot). "holes": an empty slot below the extent in
    every third cell of three or more particles, so a cell walks more than
    it holds. "extent 1": every cell of one band (margins too) holds one
    particle, in slot 0, and the band's rows ±1 keep the scene's."""
    d, p, spec = stepped_layout(cuda, layout)
    ext = cell_extents(d)
    if case == "holes":
        zs, cs = torch.nonzero(ext >= 3, as_tuple=True)
        zs, cs = zs[::3], cs[::3]
        d = with_slots(d, zs, torch.ones_like(zs), cs)
        holes = ~(d.occ[:, :-1] > 0.5) & (d.occ[:, 1:] > 0.5)
        assert int(holes.sum()) >= len(zs) > 8
        assert torch.equal(cell_extents(d), ext)
    else:
        plan = band_plan(spec)
        zs, cs = torch.nonzero(ext > 0, as_tuple=True)
        z = int(zs[len(zs) // 2])
        b = int(cs[len(cs) // 2]) // spec.X // plan.rows
        band = torch.arange(b * plan.rows * spec.X,
                            min((b + 1) * plan.rows, spec.n1) * spec.X,
                            device=cuda)
        zb = torch.full_like(band, z)
        for s in range(1, spec.k):
            d = with_slots(d, zb, torch.full_like(band, s), band)
        empty = ~(d.occ[z, 0, band] > 0.5)
        d = with_slots(d, zb[empty], torch.zeros_like(band[empty]),
                       band[empty], cell_centres(spec, zb[empty],
                                                 band[empty], cuda))
        assert bool((cell_extents(d)[z, band] == 1).all())
        assert bool(empty.any()) and bool((~empty).any())
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


@pytest.mark.parametrize("where", ["in the fluid", "alone"])
@pytest.mark.parametrize("layout", sorted(EXTENT_LAYOUTS))
def test_sweeps_keep_nan_positions(cuda, layout, where):
    """A NaN position makes NaN pair terms, which neither screen skips:
    K1 and K2 are NaN exactly where the plain versions are (the accel
    inputs come from the finite state, so only the position is NaN). A
    particle "alone", in a cell whose 26 neighbours are empty, has no
    occupied partner: its own walk still visits every partner slot, so its
    NaN terms against the empty ones give it NaN, and only it."""
    d, p, spec = stepped_layout(cuda, layout)
    if where == "alone":
        # A cell two cells or more from every particle and from the
        # array's ends.
        taken = (cell_extents(d) > 0).float().view(1, 1, spec.n0, spec.n1,
                                                   spec.X)
        if spec.stencil0:
            near = torch.nn.functional.max_pool3d(taken, 5, 1, 2)[0, 0]
        else:
            near = torch.nn.functional.max_pool2d(taken[0], 5, 1, 2)[0]
        inner = torch.zeros_like(near, dtype=torch.bool)
        inner[slice(2, -2) if spec.stencil0 else slice(None), 2:-2, 2:-2] = True
        free = torch.nonzero(((near == 0) & inner).reshape(spec.n0, spec.C))
        z, c = (int(i) for i in free[len(free) // 2])
        zs, cs = torch.tensor([z], device=cuda), torch.tensor([c], device=cuda)
        d = with_slots(d, zs, torch.zeros_like(zs), cs,
                       cell_centres(spec, zs, cs, cuda))
        k = 0
    else:
        z, k, c = (int(i) for i in torch.nonzero(d.occ > 0.5)[100])
    d2 = accel_inputs(d, p, spec)
    px = d.px.clone()
    px[z, k, c] = float("nan")
    nans = sweeps_exact(d.replace_fields(px=px), d2.replace_fields(px=px),
                        p, spec)
    if where == "alone":
        assert nans == 4     # its ρ and its three accelerations
    else:
        assert nans > 1


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
    assert LAUNCHES == launch_counts(density=12, accel=12, rebin=4,
                                     density_tail=12, integrate=12)
    m = sim.metrics()
    assert m["n_particles"] == n0 and m["dropped"] == 0


# -- the step's per-slot tail: F1 (integrate) and F2 (density_tail) --------

OBSTACLES = {
    "sphere": ("sphere", (0.35, 0.3, 0.05), 0.12),
    "box": ("box", (0.3, 0.2, 0.05), (0.1, 0.08, 0.12)),
    "cylinder_z": ("cylinder_z", (0.3, 0.25), 0.1),
}


def tail_exact(d, p, spec, acc=None, drag=None, seed=0, nan=False):
    """F2 on K1's raw ρ and F1 on K2's accelerations (stirred: every 7th
    slot kicked so the clamp and the walls fire) against their plain
    versions, every slot bitwise with NaN as NaN and equal clamp counts;
    returns F1's clamp count."""
    raw, d2, acc0 = tail_inputs(d, p, spec)
    if nan:
        raw = raw.clone()
        raw.view(-1)[torch.nonzero(d.occ.view(-1) > 0.5)[7, 0]] = \
            float("nan")
    r = check_density_tail(raw, d.occ, p)
    assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    vmax = dense.rebin_vmax(p, spec)
    d2, acc = stirred(d2, acc if acc is not None else acc0, p, vmax,
                      seed=seed, nan=nan)
    r = check_integrate(d2, *acc, p, vmax, drag=drag)
    assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    return r["n_clamped"]


def a_drag(d, cuda, strength=3000.0):
    """A drag sphere around the fluid's mean position."""
    from sph_tpu_torch.sph.model import FluidDrag

    m = d.occ > 0.5
    ctr = [float(f[m].mean()) for f in (d.px, d.py, d.pz)]
    return FluidDrag.at(ctr, [c + 0.1 for c in ctr], 0.1, strength,
                        device=cuda)


@pytest.mark.parametrize("drag", [False, True])
@pytest.mark.parametrize("obstacle", sorted(OBSTACLES))
@pytest.mark.parametrize("case", sorted(SCENES))
def test_tail_kernels_bitwise(cuda, case, obstacle, drag):
    """Each obstacle kind, with and without the drag (and a particle mass
    whose reciprocal is inexact), 3D and 2D."""
    d, p, spec = stepped(cuda, case, steps=6)
    p = p.replace(obstacles=(OBSTACLES[obstacle],),
                  particle_mass=1.3 if drag else p.particle_mass)
    n = tail_exact(d, p, spec, drag=a_drag(d, cuda) if drag else None)
    assert n > 0


def test_tail_kernels_with_every_kind_at_once_and_nan_lanes(cuda):
    d, p, spec = stepped(cuda, "3d", steps=6)
    p = p.replace(obstacles=tuple(OBSTACLES.values()) + p.obstacles)
    assert tail_exact(d, p, spec, drag=a_drag(d, cuda), seed=3,
                      nan=True) > 0


@pytest.mark.parametrize("offset", [0, 1])
def test_tail_kernels_on_sizes_not_a_multiple_of_four(cuda, offset):
    """1,021 slots (a scalar tail after the float4 groups), and the same
    slots one float past an aligned start (every pointer off 16 bytes: the
    scalar pass)."""
    d, p, spec = stepped(cuda, "3d", steps=6)
    n = 1021
    start = int(torch.nonzero(d.occ.view(-1) > 0.5)[0, 0]) // 4 * 4
    start += offset

    def cut(t):
        return t.reshape(-1)[start:start + n].view(1, 1, n)

    small = d.replace_fields(**{f: cut(getattr(d, f)) for f in (
        "px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs")})
    assert small.px.is_contiguous()
    assert (small.px.data_ptr() % 16 == 0) == (offset == 0)
    raw, _, acc = tail_inputs(d, p, spec)
    r = check_density_tail(cut(raw), small.occ, p)
    assert r["bitwise"], r
    vmax = dense.rebin_vmax(p, spec)
    r = check_integrate(small, *(cut(a) for a in acc), p, vmax,
                        drag=a_drag(d, cuda))
    assert r["bitwise"], r
    assert int(small.occ.sum()) > 0


@pytest.mark.parametrize("shape,coords", MESHES)
def test_tail_kernels_on_halo_padded_blocks(cuda, shape, coords):
    d, p, spec = stepped(cuda, "3d")
    slab, sspec = pd.fluid_slab(d, p, spec, shape, coords)
    assert tail_exact(slab, p, sspec) > 0


def test_tail_wrappers_refuse_bad_operands(cuda):
    d, p, spec = stepped(cuda, "2d", steps=0)
    z = torch.zeros_like(d.px)
    vmax = dense.rebin_vmax(p, spec)
    with pytest.raises(TypeError, match="float32"):
        integrate(d, z.double(), z, z, p, vmax)
    with pytest.raises(ValueError, match="shape"):
        integrate(d, z[:, :2], z, z, p, vmax)
    with pytest.raises(ValueError, match="CUDA"):
        integrate(d, z.cpu(), z, z, p, vmax)
    with pytest.raises(ValueError, match="contiguous"):
        density_tail(z.transpose(1, 2).contiguous().transpose(1, 2),
                     d.occ, p)
    with pytest.raises(ValueError, match="general pow"):
        density_tail(z, d.occ, p.replace(gamma=2.0))
    bad = a_drag(d, cuda)
    bad.radius = bad.radius.cpu()
    with pytest.raises(ValueError, match="drag"):
        integrate(d, z, z, z, p, vmax, drag=bad)


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
    """K3 against dense.rebin on d's own positions and velocities, each
    occupied slot's ρ and p tagged by its index: equal values on all 9
    fields (−0 == +0) and equal demand peaks; returns (plain dropped,
    kernel dropped)."""
    tag = torch.arange(d.px.numel(), device=d.px.device).view(d.px.shape)
    occ = d.occ > 0.5
    d = d.replace_fields(
        rho=torch.where(occ, 900.0 + (tag % 4099).float() * 0.125,
                        p.rest_density),
        prs=torch.where(occ, (tag % 8191).float() * 3.0, 0.0))
    args = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, p, spec)
    reset_rebin_peak()
    a = dense.rebin(d, *args)
    peak_a = int(rebin_peak(d.px.device))
    reset_rebin_peak()
    b = staged_rebin(d, *args)
    assert int(rebin_peak(d.px.device)) == peak_a > 0
    for f in ("px", "py", "pz", "vx", "vy", "vz", "rho", "prs", "occ"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    return int(a.dropped), int(b.dropped)


@pytest.mark.parametrize("name", ["3d8", "3d4", "2d4", "2d8", "3d16",
                                  "2d16"])
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
    d = layout_state(empty_layout(spec), cuda)
    args = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, p, spec)
    reset_rebin_peak()
    a, b = dense.rebin(d, *args), staged_rebin(d, *args)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.dropped) == int(b.dropped) == 0
    assert int(rebin_peak(cuda)) == 0


@pytest.mark.parametrize("name", ["3d8", "3d16"])
def test_rebin_kernel_demand_peak_on_a_planted_overfull_cell(cuda, name):
    """K + 3 particles of the plane below bound for one cell: the kernel's
    peak reads K + 3 and `dropped` 3, as the plain rebin's."""
    p, spec = small_spec(name)
    lay = empty_layout(spec)
    rng = np.random.default_rng(1)
    z, r, x = spec.n0 // 2, spec.n1 // 2, spec.n2 // 2
    for i in range(spec.k + 3):
        src = (z - 1, r, x) if i < spec.k else (z, r + 1, x)
        place_particle(lay, spec, i % spec.k, src, (z, r, x), rng)
    assert rebin_equal(layout_state(lay, cuda), p, spec) == (3, 3)
    assert int(rebin_peak(cuda)) == spec.k + 3


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


def test_one_band_and_the_cursor_left_zeroed(cuda):
    """K4 and its floor modes on one band (a one-plane slab swept as one
    band of all its rows: a grid of one block), then on the whole pack,
    each bitwise; the stream's band cursor is zeroed after every call, so
    the calls in turn on one stream each sweep every band."""
    state, params, spec = blob(n=2000, k=2, radius=14.0, spawn=16.0,
                               device=cuda)
    fields, occ, _, _ = cd._pack_args(state, spec)
    z = int((occ > 0.5).sum(dim=(1, 2)).argmax())
    one = [f[z:z + 1].contiguous() for f in (*fields, occ)]
    one_spec = dataclasses.replace(spec, nz=1)
    assert oc.plan_of(one_spec, spec.ny).bands == 1
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for f, o, sp, rows in ((one[:10], one[10], one_spec, spec.ny),
                           (fields, occ, spec, None)):
        for _ in range(2):
            floor_exact(f, o, params, sp, rows)
            torch.cuda.synchronize()
            assert oc._CURSORS[(cuda, stream)].tolist() == [0, 0]


def stages_exact(monkeypatch, fields, occ, params, spec, plan):
    """S2 (pads), S3 (screen) and K4 at a forced band `plan` against their
    plain versions: the floor modes
    bitwise at the plan's rows, K4 bitwise to `_sweep_plain` with +0 on
    empty slots. Returns the slots of the bands that hit the screen."""
    monkeypatch.setattr(oc, "band_plan", lambda _spec: plan)
    outs = {}
    for mode in ("pads", "screen"):
        outs[mode] = cf.contact_floor(fields, occ, params, spec, mode)
        plain = cf.PLAIN[mode](fields, occ, params, spec, plan.rows)
        for a, b in zip(outs[mode], plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (mode, plan)
    contact_exact(fields, occ, params, spec)
    return int((outs["screen"][0] != 0).sum())


@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_stages_on_few_planes(cuda, monkeypatch, k):
    """S2, S3 and K4 at each K on slabs of Z = 1, 2, 3 and 11 planes of a
    crowded ball (bands that hit), at the plan's rows and at 5 (Y not a
    multiple of the band's rows): the first and last planes' halos wrap
    past the slab's ends, and a one-plane slab's three staged planes are
    one plane."""
    state, params, spec = blob(n=2000, k=k, radius=14.0, spawn=16.0,
                               device=cuda)
    fields, occ, _, _ = cd._pack_args(state, spec)
    assert spec.ny % 5
    z = int((occ > 0.5).sum(dim=(1, 2)).argmax())
    hits, planned = 0, oc.band_plan(spec).rows
    for nz in (1, 2, 3, 11):
        planes = [(z - nz // 2 + i) % spec.nz for i in range(nz)]
        slab = [f[planes].contiguous() for f in (*fields, occ)]
        sspec = dataclasses.replace(spec, nz=nz)
        for rows in (planned, 5):
            plan = oc._plan(sspec, rows)
            if plan.smem_bytes <= oc.SMEM_LIMIT:
                hits += stages_exact(monkeypatch, slab[:10], slab[10],
                                     params, sspec, plan)
    assert hits > 0


@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_stages_with_margins_of_zero(cuda, monkeypatch, k):
    """S2, S3 and K4 at each K with ε equal to an overlap the pack makes
    (the median of the occupied slots' positive largest overlaps), so that
    margins are exactly 0 and pairs sit on the screen's bound, on the
    crowded ball and on it compressed ×0.7: bands hit, and every stage is
    bitwise."""
    state, params, spec = blob(n=2000, k=k, radius=14.0, spawn=16.0,
                               device=cuda)
    plan = oc.band_plan(spec)
    for st in (state, compressed(state, 0.7)):
        fields, occ, _, _ = cd._pack_args(st, spec)
        overlap = cf.screen_margin(fields, params.replace(
            contact_epsilon=0.0), spec)
        positive = overlap[(occ > 0.5) & (overlap > 0)]
        eps = float(positive.median())
        p = params.replace(contact_epsilon=eps)
        margin = cf.screen_margin(fields, p, spec)
        assert bool(((margin == 0) & (occ > 0.5)).any())
        assert stages_exact(monkeypatch, fields, occ, p, spec, plan) > 0


@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_stages_with_a_nan_position(cuda, monkeypatch, k):
    """S2, S3 and K4 at each K on a settled colony (no band hits the
    screen) with one cell's x NaN: S2 and S3 bitwise to their plain
    versions on every slot (NaN for NaN); K4 bitwise to `_sweep_plain` on
    the occupied slots, NaN where it is NaN, and +0 on the empty ones."""
    state, params, _ = bonded_colony(4000, device=cuda,
                                     **{**COLONY, "dense_k": k})
    spec = cd.make_contact_spec(params, k=k,
                                cell_factor=params.dense_cell_factor)
    pos = state.pos.clone()
    pos[7, 0] = float("nan")
    fields, occ, _, _ = cd._pack_args(state.replace_fields(pos=pos), spec)
    plan = oc.band_plan(spec)
    monkeypatch.setattr(oc, "band_plan", lambda _spec: plan)
    for mode in ("pads", "screen"):
        kern = cf.contact_floor(fields, occ, params, spec, mode)
        plain = cf.PLAIN[mode](fields, occ, params, spec, plan.rows)
        for a, b in zip(kern, plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), mode
    assert bool(kern[0].eq(0).all())          # no band hits the screen
    plain = cd._sweep_plain(
        fields, lambda *a: cd.contact_pair_terms(params, *a), 6, spec)
    kern = contact_sweep(fields, occ, params, spec)
    m = occ > 0.5
    assert bool(plain[0][m].isnan().any())
    for a, b in zip(kern, plain):
        assert torch.equal(a[m].isnan(), b[m].isnan())
        assert torch.equal(a[m].view(torch.int32).masked_fill(a[m].isnan(), 0),
                           b[m].view(torch.int32).masked_fill(b[m].isnan(), 0))
        assert not bool(a[~m].view(torch.int32).any())


@pytest.mark.parametrize("kw", [
    dict(n=4000, k=2, radius=9.0, alive=3900),     # overflow, dead rows
    dict(n=400, k=4, alive=380),                   # the probe's scene
    dict(n=3000, k=1, radius=4.0, alive=2990),     # ~100 rows a cell
])
def test_expand_kernel_bitwise_with_overflow_and_dead_rows(cuda, kw):
    """K5 bitwise on small packs, which the kernel runs one range a block
    (a search each; chip_smoke.py holds the 1M colony, two a block)."""
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


@pytest.mark.parametrize("case", SLOT_CASES)
@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_slots_kernel_bitwise_on_edge_cases(cuda, k, case):
    """The slots kernel bitwise to `_rank_and_slots` on every output; `odd
    rows` at 300,037 rows, more than one a thread of the resident grid."""
    spec = blob(n=8, k=k, spawn=16.0, device="cpu")[2]
    n = {"one row": 1, "odd rows": 300_000}.get(case, 5000)
    r = check_contact_slots(*slot_case(spec, case, seed=k, n=n, device=cuda),
                            spec)
    if case == "every row dead":
        assert r["dead"] == r["rows"] and r["fits"] == r["overflow"] == 0
    elif case == "one cell":
        assert r["fits"] == k and r["overflow"] == n - k
    elif case == "one row":
        assert r["rows"] == r["fits"] == 1
    else:
        assert r["overflow"] > 0 and r["fits"] > 0


def with_planted_values(comps, slot_of, spec):
    """K4's planes, cloned, with NaN (a payload of its own), −0 and ±inf
    at live rows' slots and at the last slot, where rows that do not fit
    read; and slot_of with every 9th particle dropped (slot_of = slots)."""
    planes = [c.reshape(-1).clone() for c in comps]
    live = slot_of[slot_of < spec.slots].long()
    nan = torch.tensor(0x7FC00123, dtype=torch.int32).view(torch.float32)
    last = (-2.0, float(nan), -0.0, 3.0, float("inf"), float("-inf"))
    for c, p in enumerate(planes):
        p[live[c::11]] = nan.item()
        p[live[c + 5::11]] = -0.0
        p[-1] = last[c]
    dropped = slot_of.clone()
    dropped[::9] = spec.slots
    return planes, dropped


@pytest.mark.parametrize("squeeze", [1.0, 0.7])
def test_gather_kernel_bitwise_with_dropped_rows_nan_and_negative_zero(
        cuda, squeeze):
    state, params, _, spec = colony(cuda, n=4000)
    fields, occ, slot_of, overflow = cd._pack_args(compressed(state, squeeze),
                                                   spec)
    comps = contact_sweep(fields, occ, params, spec)
    r = check_contact_gather([c.reshape(-1) for c in comps], slot_of,
                             overflow)
    assert r["particles"] == 4000
    r = check_contact_gather(*with_planted_values(comps, slot_of, spec),
                             overflow)
    assert r["dropped"] >= 4000 // 9 and r["nan_rows"] > 0


def test_contact_forces_kernel_route_equals_plain_route(cuda):
    """contact_forces_dense through the slots kernel, K5, K4 and the
    gather kernel, one launch each, bitwise to the plain route on a
    compressed colony where contact fires."""
    state, params, _, spec = colony(cuda)
    squeezed = compressed(state, 0.7)
    reset_launches()
    got = cd.contact_forces_dense(squeezed, params, spec)
    torch.cuda.synchronize()
    assert LAUNCHES == launch_counts(contact_slots=1, expand=1, contact=1,
                                     contact_gather=1)
    want = cd.contact_forces_dense(squeezed, params.replace(use_pallas=False),
                                   spec)
    assert float(want[0].abs().max()) > 0
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got[2]) == int(want[2])


class MeshInOneProcess:
    """Rank `coords` of a mesh of `shape`, with every rank in this one
    process: `all_gather_blocks` puts together the blocks in `blocks`
    (coords → block, in the mesh's order as parallel.dist.Mesh does), or,
    when `blocks` lacks a rank's, stores this rank's and raises
    `Collected`."""

    class Collected(Exception):
        pass

    def __init__(self, shape, coords, blocks):
        self.shape, self.coords, self.blocks = shape, coords, blocks
        self.ndim = len(shape)

    def all_gather_blocks(self, t, dims):
        if len(self.blocks) < int(np.prod(self.shape)):
            self.blocks[self.coords] = t
            raise self.Collected
        if self.ndim == 1:
            return torch.cat([self.blocks[(z,)] for z in range(self.shape[0])],
                             dim=dims[0])
        return torch.cat([
            torch.cat([self.blocks[(z, y)] for y in range(self.shape[1])],
                      dim=dims[1])
            for z in range(self.shape[0])], dim=dims[0])


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_sharded_contact_through_the_kernels_equals_plain(cuda, shape):
    """The sharded contact forces (parallel.dist `_contact_forces`) at the
    ranks' block shapes, each rank's sweep run here: the slots kernel and
    K5 on the replicated pack, K4 on each block, the gather kernel after
    the mesh's gather; bitwise to the single-device plain route."""
    state, params, _, spec = colony(cuda, n=4000)
    squeezed = compressed(state, 0.7)
    blocks = {}
    for coords in np.ndindex(*shape):
        mesh = MeshInOneProcess(shape, coords, blocks)
        with pytest.raises(MeshInOneProcess.Collected):
            pd._contact_forces(params, mesh, spec)(squeezed)
    reset_launches()
    got = pd._contact_forces(params, mesh, spec)(squeezed)
    assert LAUNCHES["contact_slots"] == LAUNCHES["contact_gather"] == 1
    want = cd.contact_forces_dense(squeezed, params.replace(use_pallas=False),
                                   spec)
    assert float(want[0].abs().max()) > 0
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got[2]) == int(want[2])


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
    assert LAUNCHES["contact_slots"] == LAUNCHES["contact_gather"] == 10
    assert LAUNCHES["bond_rows"] == 10
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
    fields, occ, slot_of, _ = cd._pack_args(state, spec, expand=True)
    with pytest.raises(TypeError, match="float32"):
        contact_sweep([fields[0].double(), *fields[1:]], occ, params, spec)
    with pytest.raises(ValueError, match="shape"):
        contact_sweep([f[:, :8] for f in fields], occ, params, spec)
    rows, _, _, key, _, _ = cd._sort_with_payload(state, spec)
    with pytest.raises(ValueError, match="int32"):
        expand_rows(rows, key.long(), cd.PACK_FILLS, spec)
    with pytest.raises(ValueError, match="fills"):
        expand_rows(rows, key, cd.PACK_FILLS[:5], spec)
    cid_s, order = torch.sort(cd._cell_ids(state, spec), stable=True)
    with pytest.raises(ValueError, match="CUDA"):
        ocs.rank_and_slots(cid_s, order.cpu(), spec)
    with pytest.raises(ValueError, match="int64"):
        ocs.rank_and_slots(cid_s, order.int(), spec)
    comps = contact_sweep(fields, occ, params, spec)
    planes = [c.reshape(-1) for c in comps]
    with pytest.raises(ValueError, match="CUDA"):
        ocs.gather_back([planes[0].cpu(), *planes[1:]], slot_of, None)
    with pytest.raises(ValueError, match="int32"):
        ocs.gather_back(planes, slot_of.long(), None)


# -- the adhesion pass's per-bond rows: A1 (bond_rows) ---------------------


def adhesion_colony(cuda, case="settled"):
    """A 4,096-cell colony for A1, as `case`: as built; with
    utils.verify.bond_edge_cases (slots of −1, inactive bonds, coincident
    endpoints, NaN endpoints, every constraint loaded); the same without
    NaN ("loaded"), also with the anchor constraints off; or with 8,229
    bond rows (not a multiple of the kernel's 256-bond tile) and the edge
    cases. Returns (state, params, device genome)."""
    kw = {"max_bonds": 8229} if case == "odd bond count" else {}
    state, params, genome = bonded_colony(4096, device=cuda, **COLONY, **kw)
    if case in ("edge cases", "odd bond count"):
        state = bond_edge_cases(state)
    elif case in ("loaded", "anchors off"):
        state = bond_edge_cases(state, nan=False)
    if case == "anchors off":
        params = params.replace(enable_anchor_constraints=False)
    return state, params, genome.to_device(cuda)


@pytest.mark.parametrize("case", ["settled", "edge cases", "anchors off",
                                  "odd bond count"])
def test_bond_rows_kernel_bitwise(cuda, case):
    state, params, gd = adhesion_colony(cuda, case)
    r = check_bond_rows(state, params, gd)
    assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    assert r["rows"] == adh.padded_rows(state.bonds.capacity)
    assert r["loaded"]["dv"] > 0
    assert (r["loaded"]["dq"] > 0) == (case != "anchors off")
    r = check_bond_rows(state, params, gd, dt=0.37 * params.dt)
    assert r["bitwise"], r


def test_bond_rows_wrapper_refuses_bad_operands(cuda):
    state, params, gd = adhesion_colony(cuda)
    b = state.bonds
    cases = [
        (TypeError, "float32", dict(mass=state.mass.double())),
        (ValueError, "CUDA", dict(rot=state.rot.cpu())),
        (ValueError, "contiguous",
         dict(pos=state.pos.t().contiguous().t())),
        (ValueError, "int32", dict(bonds=b.replace_fields(
            slot_a=b.slot_a.long()))),
        (ValueError, "shape", dict(bonds=b.replace_fields(
            rel_orientation=b.rel_orientation[:, :3].contiguous()))),
    ]
    for error, match, fields in cases:
        with pytest.raises(error, match=match):
            bond_rows(state.replace_fields(**fields), params, gd)


@pytest.mark.parametrize("branch, n_rewrite", [
    ("plain", 0), ("quiet", 0), ("hybrid", 60), ("full", 2200)])
def test_adhesion_branches_equal_eager_path(cuda, branch, n_rewrite):
    """bond_deltas through A1 against the same accumulate fed the plain
    bond_rows on the card, with no plan and in each branch of a plan made
    stale by rewritten endpoints: the same Δv and Δq, bitwise."""
    state, params, gd = adhesion_colony(cuda, "loaded")
    n = state.capacity
    plan = None if branch == "plain" else adh.build_bond_plan(state.bonds, n)
    b = state.bonds
    live = torch.nonzero(b.active)[:, 0]
    g = torch.Generator(device=cuda).manual_seed(5)
    pick = live[torch.randperm(live.numel(), generator=g,
                               device=cuda)[:n_rewrite]]
    slot_a = b.slot_a.clone()
    slot_a[pick] = torch.randint(0, n, (n_rewrite,), generator=g,
                                 device=cuda, dtype=slot_a.dtype)
    state = state.replace_fields(bonds=b.replace_fields(slot_a=slot_a))
    adh.reset_plan_counts()
    got = adh.bond_deltas(state, params, gd, plan=plan)
    rows = adh.bond_rows(state, params, gd)
    if plan is None:
        want = adh.accumulate_bond_deltas(
            rows, *adh._segments(state.bonds, n), n)
    else:
        assert adh.PLAN_COUNTS[branch] == 1
        want = adh.accumulate_bond_deltas_hybrid(rows, state.bonds, n, plan)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert float(got[1].abs().max()) > 0


# -- the planned accumulate: A2 (bond_scan) ---------------------------------

# name: (cells, bonds, seed, active, special), tests/test_torch_bondplan.py's
# A2_CASES and one of 1,000 blocks.
SCAN_CASES = {
    "one block": (40, 200, 1, 0.7, False),
    "24 blocks": (300, 6144, 2, 0.7, False),
    "23 blocks, runs across blocks": (9, 5800, 3, 0.9, False),
    "drop run over 4 blocks": (300, 6144, 4, 0.5, False),
    "NaN, inf, -0 rows": (300, 6144, 6, 0.7, True),
    "1,000 blocks": (100_000, 256_000, 9, 0.8, True),
    "all -0 rows, runs across blocks": (9, 5800, 10, 0.9, False),
}


def scan_exact(r):
    assert r["bitwise"] and r["max_abs_err"] == 0.0, r
    assert r["same_bits"], r
    assert r["with_bonds"] > 0


@pytest.mark.parametrize("zb", [False, True])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_bond_scan_kernel_bitwise(cuda, case, zb):
    """A2 against the plain planned accumulate on random plans (one block,
    23, 24 and 1,000 blocks; runs crossing block edges and over three
    blocks long; NaN, ±inf and −0 rows; rows of −0 alone), without and
    with a zero_bond mask, its block totals scanned in one block a
    component and a launch a level: every particle's bits."""
    cells, bonds, seed, active, special = SCAN_CASES[case]
    _, plan, rows, zero_bond = bond_scan_case(cells, bonds, seed, active,
                                              special, device=cuda)
    if case.startswith("all -0"):
        rows = torch.full_like(rows, -0.0)
    r = check_bond_scan(rows, plan, zero_bond if zb else None)
    scan_exact(r)
    torch.cuda.synchronize()
    cursor = oc._CURSORS[(cuda, torch.cuda.current_stream(cuda).cuda_stream)]
    assert not bool(cursor.any())
    if special and not zb:
        assert r["nan_particles"] > 0


@pytest.mark.parametrize("name", sorted(END_PLANS))
def test_bond_scan_kernel_bitwise_on_hand_plans(cuda, name):
    """A2 on utils.verify.END_PLANS' rows of −0, where each add of a +0
    shows in the sign: runs ending at block offsets 2^k − 1, and plans
    with no start at row 0, whose first block totals take the pads' +0
    and whose first block its +0 prefix."""
    plan = end_plan(name, device=cuda)
    rows = torch.full((plan.perm.shape[0], 7), -0.0, device=cuda)
    scan_exact(check_bond_scan(rows, plan))


@pytest.fixture(scope="module")
def colony_1m():
    """The 1,048,576-cell colony (the benchmark's size, 1,818,624 bond
    rows) with its A1 rows and plan; with bond_edge_cases' rows too; its
    params and contact spec."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    state, params, genome = bonded_colony(1_048_576, device=dev, **COLONY)
    gd = genome.to_device(dev)
    plan = adh.build_bond_plan(state.bonds, state.capacity)
    spec = cd.make_contact_spec(params, k=params.dense_k,
                                cell_factor=params.dense_cell_factor)
    return (state, plan, bond_rows(state, params, gd),
            bond_rows(bond_edge_cases(state), params, gd), params, spec)


@pytest.mark.parametrize("case", ["settled", "edge cases", "hybrid"])
def test_bond_scan_kernel_bitwise_at_the_1m_colony(colony_1m, case):
    """A2 at the benchmark's colony: its plan (7,104 blocks), A1's rows as
    built and with the edge cases (NaN rows among them), and with the
    hybrid's zero_bond mask of 2,000 rewritten bonds."""
    state, plan, rows, rows_e, _, _ = colony_1m
    zero_bond = None
    if case == "hybrid":
        n = state.capacity
        b = state.bonds
        g = torch.Generator(device=rows.device).manual_seed(3)
        live = torch.nonzero(b.active)[:, 0]
        pick = live[torch.randperm(live.numel(), generator=g,
                                   device=rows.device)[:2000]]
        slot_a = b.slot_a.clone()
        slot_a[pick] = torch.randint(0, n, (2000,), generator=g,
                                     device=rows.device, dtype=slot_a.dtype)
        zero_bond = adh.plan_changed(b.replace_fields(slot_a=slot_a), plan)
        assert 0 < int(zero_bond.sum()) <= 2000
    r = check_bond_scan(rows_e if case == "edge cases" else rows, plan,
                        zero_bond)
    scan_exact(r)
    assert r["blocks"] == 7104
    assert (r["nan_particles"] > 0) == (case == "edge cases")


@pytest.mark.parametrize("squeeze", [1.0, 0.7])
def test_slots_and_gather_kernels_bitwise_at_the_1m_colony(colony_1m,
                                                           squeeze):
    """The slots kernel on the benchmark colony's own pack sort, and the
    gather kernel on K4's planes there, settled and compressed ×0.7."""
    state, _, _, _, params, spec = colony_1m
    state = compressed(state, squeeze)
    cid_s, order = torch.sort(cd._cell_ids(state, spec), stable=True)
    r = check_contact_slots(cid_s, order, spec)
    assert r["rows"] == 1_048_576 and r["fits"] > 0
    fields, occ, slot_of, overflow = cd._pack_args(state, spec)
    comps = contact_sweep(fields, occ, params, spec)
    r = check_contact_gather([c.reshape(-1) for c in comps], slot_of,
                             overflow)
    assert r["particles"] == 1_048_576


@pytest.mark.parametrize("branch, n_rewrite", [("quiet", 0), ("hybrid", 60)])
def test_hybrid_through_bond_scan_equals_eager(cuda, monkeypatch, branch,
                                               n_rewrite):
    """accumulate_bond_deltas_hybrid with A2 against the same with the
    plain planned accumulate in its place, on A1's rows of a plan made
    stale by rewritten endpoints: bitwise, one A2 launch a call."""
    state, params, gd = adhesion_colony(cuda, "loaded")
    n = state.capacity
    plan = adh.build_bond_plan(state.bonds, n)
    b = state.bonds
    g = torch.Generator(device=cuda).manual_seed(7)
    live = torch.nonzero(b.active)[:, 0]
    pick = live[torch.randperm(live.numel(), generator=g,
                               device=cuda)[:n_rewrite]]
    slot_a = b.slot_a.clone()
    slot_a[pick] = torch.randint(0, n, (n_rewrite,), generator=g,
                                 device=cuda, dtype=slot_a.dtype)
    bonds = b.replace_fields(slot_a=slot_a)
    rows = bond_rows(state.replace_fields(bonds=bonds), params, gd)
    adh.reset_plan_counts()
    reset_launches()
    got = adh.accumulate_bond_deltas_hybrid(rows, bonds, n, plan)
    assert LAUNCHES["bond_scan"] == 1 and adh.PLAN_COUNTS[branch] == 1
    monkeypatch.setattr(oa, "bond_scan", adh.accumulate_bond_deltas_planned)
    want = adh.accumulate_bond_deltas_hybrid(rows, bonds, n, plan)
    assert LAUNCHES["bond_scan"] == 1
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert float(got[1].abs().max()) > 0


def test_bond_scan_wrapper_refuses_bad_operands(cuda):
    _, plan, rows, zero_bond = bond_scan_case(300, 6144, 2, device=cuda)
    mp = rows.shape[0]
    # The least multiple of 512 rows whose 7 columns pass 2^31 elements,
    # and as many particles: stride-0 views, nothing allocated.
    big = -(-(2 ** 31) // (7 * 512)) * 512
    cases = [
        (TypeError, "float32", dict(rows=rows.double())),
        (ValueError, "shape", dict(rows=rows[:, :6])),
        (ValueError, "multiple of 512", dict(rows=rows[:-8])),
        (ValueError, "32-bit", dict(rows=torch.zeros(
            (1, 1), device=cuda).expand(big, 7))),
        (ValueError, "32-bit", dict(last=torch.zeros(
            1, dtype=torch.int64, device=cuda).expand(big))),
        (ValueError, "CUDA", dict(perm=plan.perm.cpu())),
        (ValueError, "int64", dict(perm=plan.perm.int())),
        (ValueError, "bool", dict(flags=plan.flags.to(torch.uint8))),
        (ValueError, "shape", dict(has=plan.has[:-1])),
        (ValueError, "zero_bond", dict(zero_bond=torch.zeros(
            mp, dtype=torch.bool, device=cuda))),
        (ValueError, "bool", dict(zero_bond=zero_bond.int())),
        (ValueError, "contiguous",
         dict(rows=rows.t().contiguous().t())),
    ]
    for error, match, fields in cases:
        zb = fields.pop("zero_bond", zero_bond)
        r = fields.pop("rows", rows)
        with pytest.raises(error, match=match):
            oa.bond_scan(r, plan.replace_fields(**fields), zb)
    assert big * 7 >= 2 ** 31 > (big - 512) * 7


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
    assert LAUNCHES["density_tail"] == LAUNCHES["integrate"] == 12
    assert LAUNCHES["rebin"] == 12       # config[3]: a rebin every 2 steps
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 2 and '"dropped": 0' in lines[-1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_00000.png", "frame_00001.png"]
