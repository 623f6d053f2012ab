"""The kernel wrappers and the kernel build, on the CPU: a CPU tensor takes
the plain PyTorch version (and counts no launch), the dense step's kernel
flag changes nothing there, the fluid sweeps' band planner fits shared
memory and covers the layout, the count of the partner slots their walk
screens (`sweep_screens`) equals one made slot by slot, the build refuses
cleanly without a CUDA toolkit, and `launch_counts` spells an expectation
over every kernel. The kernels themselves are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from sph_tpu_torch.ops import LAUNCHES, build, launch_counts, reset_launches
from sph_tpu_torch.ops import fluid
from sph_tpu_torch.ops.fluid import accel_sweep, band_plan, density_sweep
from sph_tpu_torch.ops.rebin import staged_rebin
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.scenes import dam_break_2d, dam_break_3d_obstacle
from sph_tpu_torch.utils.verify import accel_inputs, check_fluid_twins, nudge

torch.set_num_threads(1)


def small_state(scene, kw):
    st, p = scene(**kw)
    spec = dense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)
    return dense.pack(st, p, spec, device="cpu"), p, spec


CASES = {
    "3d": (dam_break_3d_obstacle, dict(n_target=3000, cell_factor=1.38,
                                       dense_k=8, rebin_every=6)),
    "2d": (dam_break_2d, dict(n_target=300, dense_k=4, cell_factor=1.2,
                              rebin_every=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_take_plain_route_on_cpu(case):
    d, p, spec = small_state(*CASES[case])
    reset_launches()
    assert torch.equal(density_sweep(d.px, d.py, d.pz, d.occ, p, spec),
                       dense.density_raw(d.px, d.py, d.pz, p, spec))
    d2 = accel_inputs(d, p, spec)
    pr2 = d2.prs / (d2.rho * d2.rho)
    for a, b in zip(accel_sweep(d2, pr2, p, spec),
                    dense.accel_raw(d2, torch.reciprocal(d2.rho), pr2, p,
                                    spec)):
        assert torch.equal(a, b)
    px, py, pz = nudge(d, spec, p, seed=0)
    a = staged_rebin(d, px, py, pz, d.vx, d.vy, d.vz, p, spec)
    b = dense.rebin(d, px, py, pz, d.vx, d.vy, d.vz, p, spec)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "dropped"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not any(LAUNCHES.values())
    # The live-card check runs end to end here too (trivially equal).
    r = check_fluid_twins(d, p, spec)
    assert r["rebin"]["dropped"] > 0
    assert r["density"]["max_abs_err"] == 0.0


def test_kernel_flag_is_inert_on_cpu():
    d, p, spec = small_state(*CASES["3d"])
    a = dense.dense_step(d, p.replace(use_pallas=True), spec, rebin_now=True)
    b = dense.dense_step(d, p.replace(use_pallas=False), spec,
                         rebin_now=True)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs",
              "dropped", "clamped", "step_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# The specs the card runs: config[3] (chip_smoke.py's main path) and
# chip_smoke.py's 2D scene.
PLANNED = {
    "config3": (dam_break_3d_obstacle, dict(n_target=1_000_000,
                                            cell_factor=1.38, dense_k=8,
                                            rebin_every=6)),
    "2d": (dam_break_2d, dict(n_target=4096, dense_k=4, cell_factor=1.2,
                              rebin_every=3)),
}


def planned_spec(case):
    scene, kw = PLANNED[case]
    _, p = scene(**kw)
    return dense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)


@pytest.mark.parametrize("case", sorted(PLANNED))
def test_band_plan_fits_and_covers(case):
    spec = planned_spec(case)
    plan = band_plan(spec)
    if case == "config3":
        assert (spec.n0, spec.k, spec.C, spec.X) == (145, 8, 7680, 80)
        assert (plan.rows, plan.planes) == (2, 3)
    else:
        assert not spec.stencil0 and spec.k == 4 and plan.planes == 1
    # Two sweep blocks (each with the 1 KB the system reserves) fit in an
    # SM's 228 KB, so one fits in a block's 232,448 bytes.
    assert 2 * (plan.smem_bytes + 1024) <= 233_472
    assert plan.smem_bytes <= fluid.SMEM_TARGET <= 232_448
    assert plan.smem_bytes == (
        16 * fluid.partners(spec)
        + 4 * (3 * plan.planes * spec.k * plan.run + spec.k * plan.rows
               * spec.X + fluid.LOADS * fluid.THREADS // 32) + 16)
    # The bands cover every row exactly once.
    rows = [r for b in range(plan.bands)
            for r in range(b * plan.rows, min((b + 1) * plan.rows, spec.n1))]
    assert rows == list(range(spec.n1))
    for b in range(plan.bands):
        # The fused range the kernel copies for band b, clipped to the array.
        lo = (b * plan.rows - 1) * spec.X - fluid.PAD
        start, stop = max(lo, 0), min(lo + plan.run, spec.C)
        r0, r1 = b * plan.rows, min((b + 1) * plan.rows, spec.n1)
        # The copied halo lies inside the array, in 16-byte runs, within
        # the staged buffer, and holds every row ±1 that exists.
        assert 0 <= start < stop <= spec.C
        assert start % fluid.PAD == 0 and stop % fluid.PAD == 0
        assert stop - start <= plan.run
        assert start <= max(r0 - 1, 0) * spec.X
        assert stop >= min(r1 + 1, spec.n1) * spec.X
    # A larger band would not keep two blocks on an SM.
    if plan.rows < min(fluid.MAX_BAND_ROWS, spec.n1):
        larger = fluid._plan(spec, plan.rows + 1)
        assert larger.smem_bytes > fluid.SMEM_TARGET


def test_band_plan_refuses_what_does_not_fit():
    spec = planned_spec("config3")
    wide = dataclasses.replace(spec, n2=1280)       # a row of 1,280 cells
    assert fluid._plan(wide, 1).smem_bytes > 232_448
    with pytest.raises(ValueError, match="shared memory"):
        band_plan(wide)
    with pytest.raises(ValueError, match="K in"):
        band_plan(dataclasses.replace(spec, k=6))
    with pytest.raises(ValueError, match="multiple of 4"):
        band_plan(dataclasses.replace(spec, n2=90))


def screen_layout(name, seed=0):
    """A small layout whose cells hold particles in their first slots, 0
    to K/4 in the first half of the rows and 0 to K in the rest, with holes
    (an empty slot below an occupied one) and one band emptied; or no
    particle at all ("empty")."""
    k, n0, n1, n2 = {"3d4": (4, 3, 20, 16), "3d16": (16, 3, 12, 8),
                     "2d8": (8, 1, 24, 16), "empty": (8, 3, 16, 16)}[name]
    spec = dense.DenseSpec(n0=n0, n1=n1, n2=n2, k=k, cell=1.0,
                           origin=(0.0, 0.0, 0.0), ndim=3 if n0 > 1 else 2,
                           axis_map=(0, 1, 2) if n0 > 1 else (2, 1, 0),
                           stencil0=n0 > 1)
    rng = np.random.default_rng(seed)
    occ = np.zeros((n0, k, spec.C), np.float32)
    if name != "empty":
        rows = np.arange(spec.C) // n2
        fill = rng.integers(0, np.where(rows < n1 // 2, k // 4, k) + 1,
                            size=(n0, spec.C))
        occ[:] = np.arange(k)[None, :, None] < fill[:, None, :]
        holes = rng.random((n0, k, spec.C)) < 0.15
        holes[:, -1] = False
        occ[holes & (fill[:, None, :] > 2)] = 0.0
        band = band_plan(spec).rows * n2
        occ[n0 // 2, :, band:2 * band] = 0.0
    return torch.from_numpy(occ), spec


def slot_by_slot(occ, spec):
    """The walk's screens as their definition states them, one own slot
    and partner at a time: an own slot needs each stencil partner (cell,
    sel) below its cell's extent; each warp of 32 listed slots of a band
    screens, in the extent walk, the own cell's K − 1 partners and, of each
    other cell, as many slots as the largest extent among its lanes, and in
    the full walk every partner."""
    o = occ.numpy() > 0.5
    n0, k, c_len = o.shape
    x, s0, plan = spec.X, int(spec.stencil0), band_plan(spec)
    ext = np.zeros((n0 + 2, c_len + 2 * x + 2), int)
    for z in range(n0):
        for c in range(c_len):
            used = np.nonzero(o[z, :, c])[0]
            ext[z + 1, c + x + 1] = used.max() + 1 if used.size else 0
    cells = [(dz, dy, dx) for dz in range(-s0, s0 + 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]
    stencil = [(cell, sel) for cell in cells for sel in range(k)
               if cell != (0, 0, 0) or sel]
    n = warps = lane = warp = 0
    for z in range(n0):
        for b in range(plan.bands):
            band = range(b * plan.rows * x, min((b + 1) * plan.rows,
                                                spec.n1) * x)
            own = [(s, c) for s in range(k) for c in band if o[z, s, c]]
            n += len(own)
            for w in range(0, len(own), 32):
                lanes = own[w:w + 32]
                warps += 1
                for s, c in lanes:
                    lane += sum((s + sel) % k < ext[z + 1 + dz,
                                                     c + x + 1 + dy * x + dx]
                                for (dz, dy, dx), sel in stencil)
                if not fluid.extent_walk(k):
                    warp += len(stencil)
                    continue
                warp += k - 1
                for dz, dy, dx in cells:
                    if (dz, dy, dx) != (0, 0, 0):
                        warp += max(ext[z + 1 + dz, c + x + 1 + dy * x + dx]
                                    for _, c in lanes)
    return fluid.Screens(occupied=n, warps=warps, partners=len(stencil),
                         lane=lane, warp=warp)


@pytest.mark.parametrize("name", ["3d4", "3d16", "2d8", "empty"])
def test_sweep_screens_equal_a_count_slot_by_slot(name):
    occ, spec = screen_layout(name)
    got = fluid.sweep_screens(occ, spec)
    assert got == slot_by_slot(occ, spec)
    assert got.partners == fluid.partners(spec)
    if name == "empty":
        assert (got.occupied, got.warps, got.lane, got.warp) == (0, 0, 0, 0)
        return
    # Holes were made and a band emptied; the warps walk at least what
    # their lanes need, and the extent walk (16 slots) less than the full
    # stencil.
    o = occ > 0.5
    assert bool((~o[:, :-1] & o[:, 1:]).any())
    assert got.lane_share < got.warp_share
    assert (got.warp_share < 1.0) == fluid.extent_walk(spec.k)


def test_extents_are_the_highest_occupied_slot_plus_one():
    occ, spec = screen_layout("3d4", seed=1)
    ext = fluid.extents(occ)
    assert ext.shape == (spec.n0, spec.C) and ext.dtype == torch.int32
    for z, c in [(0, 0), (1, 37), (2, 200), (1, spec.C - 1)]:
        used = torch.nonzero(occ[z, :, c] > 0.5)
        assert int(ext[z, c]) == (int(used.max()) + 1 if len(used) else 0)


def test_operand_checks_refuse_non_cuda():
    d, p, spec = small_state(*CASES["2d"])
    with pytest.raises(ValueError, match="CUDA"):
        build.check_operands("density_sweep", (d.px,), d.px.shape,
                             d.px.device)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        build.check_launch("density_sweep", 9)
    build.check_launch("density_sweep", 0)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launch_counts_names_only_the_kernels_that_run(name):
    want = launch_counts(**{name: 3})
    assert list(want) == list(LAUNCHES)
    assert want[name] == 3
    assert not any(n for k, n in want.items() if k != name)


def test_launch_counts_knows_the_slot_kernels():
    """The contact pass's slot bookkeeping kernels are in the roster, so a
    colony expectation can name them."""
    want = launch_counts(contact_slots=2, contact_gather=2, contact=2,
                         expand=2)
    assert want["contact_slots"] == want["contact_gather"] == 2
    assert sum(want.values()) == 8


def test_launch_counts_refuses_a_name_that_is_no_kernel():
    assert launch_counts() == dict.fromkeys(LAUNCHES, 0)
    with pytest.raises(KeyError, match="bond_scans"):
        launch_counts(contact=1, bond_scans=1)


def test_build_recipe(tmp_path, monkeypatch):
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fmad" not in flags
    assert build.BUILD_DIR.parts[-2:] == ("build", "sph_tpu_torch")
    for name in build.SOURCES:
        assert (build.CSRC_DIR / name).is_file()
    # The library name follows the sources: an edit means a rebuild.
    h0 = build.source_hash()
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    assert build.source_hash() == h0
    (copy / build.SOURCES[0]).write_text("// edited\n")
    h1 = build.source_hash()
    assert h1 != h0
    for name in build.HEADERS:       # an included header counts too
        (copy / name).write_text("// edited\n")
        assert build.source_hash() != h1


def test_build_without_toolkit_raises(tmp_path, monkeypatch):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(build, "_LOADED", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()
    assert build._LOADED is None
    assert not (tmp_path / "build").exists()
