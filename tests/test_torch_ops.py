"""The kernel wrappers and the kernel build, on the CPU: a CPU tensor takes
the plain PyTorch version (and counts no launch), the dense step's kernel
flag changes nothing there, the fluid sweeps' band planner fits shared
memory and covers the layout, the build refuses cleanly without a CUDA
toolkit, and `launch_counts` spells an expectation over every kernel. The
kernels themselves are checked on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
import shutil

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
