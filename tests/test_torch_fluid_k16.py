"""The dense fluid engine at 16 slots a cell, config[3]'s layout, on the
CPU: the port's plain sweeps and rebin (the plain versions of K1, K2 and
K3) against the JAX package's twins, whose plain path takes any even K;
the rebin's demand peak and `dropped` on planted overfull cells; the fluid
step's spans; and the port's FluidSimulation against the benchmark's
plain WCSPH reference (benchmark/reference/fluid.py) on a seeded dam
break with the pillar.

Tolerances: the sweeps use the JAX twin contract (rtol 1e-5, atol
1e-6·max|x| on occupied slots, as tests/test_torch_dense.py); the rebin is
bitwise (−0 == +0); the reference comparison uses the benchmark's own
limits (benchmark/configs/dam_break_obstacle_1m.json)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.drivers.fluid_frames import _flat, compare
from benchmark.harness import spec as bspec
from benchmark.reference import fluid as reference
from benchmark.scenes import dam_break_obstacle
from sph_tpu.sph import dense as jdense
from sph_tpu.sph import model as jmodel
from sph_tpu.sph import scenes as jscenes
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.ops import rebin_peak, reset_rebin_peak
from sph_tpu_torch.sph import dense as tdense
from sph_tpu_torch.sph import scenes as tscenes
from sph_tpu_torch.sph.model import SPHParams, SPHState
from sph_tpu_torch.utils.verify import (
    empty_layout,
    moved_layout,
    overflow_layout,
    place_particle,
)

torch.set_num_threads(1)

CYL = (("cylinder_z", (0.3, 0.4), 0.1),)
SCENE = dict(n_target=800, obstacles=CYL, dense_k=16, cell_factor=1.2,
             use_pallas=False)
FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "occ")


@pytest.fixture(scope="module")
def twin():
    """One 3D scene at K = 16 packed in both packages from one lattice."""
    st_j, jp = jscenes.dam_break_3d(**SCENE)
    st_t, tp = tscenes.dam_break_3d(**SCENE)
    jspec = jdense.make_dense_spec(jp, k=16, cell_factor=1.2)
    tspec = tdense.make_dense_spec(tp, k=16, cell_factor=1.2)
    assert (jspec.n0, jspec.k, jspec.C) == (tspec.n0, tspec.k, tspec.C)
    jd = jdense.pack(st_j, jp, jspec)
    td = tdense.pack(st_t, tp, tspec, device="cpu")
    return jd, jp, jspec, td, tp, tspec


def close(x, p, occ):
    x, p = np.asarray(x)[occ], np.asarray(p)[occ]
    np.testing.assert_allclose(p, x, rtol=1e-5, atol=1e-6 * np.abs(x).max())


def test_plain_sweeps_match_jax_twin_at_k16(twin):
    jd, jp, jspec, td, tp, tspec = twin
    occ = np.asarray(jd.occ) > 0.5
    rho_j = jdense.density_pass(jd, jp, jspec)
    rho_t = tdense.density_pass(td, tp, tspec)
    close(rho_j, rho_t.numpy(), occ)
    rho = np.asarray(rho_j)
    prs = np.asarray(jnp.where(jd.occ > 0.5, jmodel.eos_pressure(rho, jp),
                               0.0))
    vx = (np.sin(np.asarray(jd.px) * 3) * occ).astype(np.float32)
    new = dict(rho=rho, prs=prs, vx=vx)
    jd2 = jd.replace_fields(**{k: jnp.asarray(v) for k, v in new.items()})
    td2 = td.replace_fields(**{k: torch.from_numpy(np.array(v))
                               for k, v in new.items()})
    a_j = jdense.accel_pass(jd2, jp, jspec)
    a_t = tdense.accel_pass(td2, tp, tspec)
    assert np.abs(np.asarray(a_j[0])[occ]).max() > 0
    for x, p in zip(a_j, a_t):
        close(x, p.numpy(), occ)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_rebin_matches_jax_twin_at_k16(twin, seed):
    """Far moves and crowded cells (moved_layout: moves of up to two
    cells): equal fields and equal `dropped` > 0. Each particle's ρ and p
    move with it: they land where the JAX twin, which leaves ρ and p in
    place, moves a velocity plane that carries them."""
    _, jp, jspec, _, tp, tspec = twin
    lay = moved_layout(tspec, seed)
    zeros = np.zeros_like(lay["occ"])
    tag = np.arange(zeros.size, dtype=np.float32).reshape(zeros.shape)
    occ = lay["occ"] > 0.5
    rho = np.where(occ, 900.0 + tag % 4099 * 0.125, jp.rest_density)
    prs = np.where(occ, tag % 8191 * 3.0, 0.0)
    lay = dict(lay, rho=rho.astype(np.float32), prs=prs.astype(np.float32))
    jd = jdense.DenseFluidState(
        **{f: jnp.asarray(lay[f]) for f in FIELDS + ("rho", "prs")},
        dropped=jnp.int32(0), clamped=jnp.int32(0), step_count=jnp.int32(0))
    td = layout_state(lay)
    a = jdense.rebin(jd, *(getattr(jd, f) for f in FIELDS[:6]), jp, jspec)
    b = tdense.rebin(td, *(getattr(td, f) for f in FIELDS[:6]), tp, tspec)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
    assert int(a.dropped) == int(b.dropped) > 0
    carried = jdense.rebin(jd, jd.px, jd.py, jd.pz, jd.rho, jd.prs, jd.vz,
                           jp, jspec)
    placed = np.asarray(carried.occ) > 0.5
    np.testing.assert_array_equal(
        np.where(placed, np.asarray(carried.vx), jp.rest_density),
        b.rho.numpy())
    np.testing.assert_array_equal(np.asarray(carried.vy), b.prs.numpy())


def layout_state(lay):
    """A port state of a layout's fields; ρ and p 0 unless it has them."""
    zeros = np.zeros(lay["occ"].shape, np.float32)
    lay = {"rho": zeros, "prs": zeros, **lay}
    i32 = torch.zeros((), dtype=torch.int32)
    return tdense.DenseFluidState(
        **{f: torch.from_numpy(lay[f]) for f in FIELDS + ("rho", "prs")},
        dropped=i32, clamped=i32, step_count=i32)


def small_spec(k):
    _, p = tscenes.dam_break_3d(n_target=1000, cell_factor=1.2)
    return p, tdense.make_dense_spec(p, k=k, cell_factor=1.2)


def rebinned(lay, p, spec):
    """(dropped, demand peak) of one plain rebin of the layout."""
    d = layout_state(lay)
    reset_rebin_peak()
    out = tdense.rebin(d, *(getattr(d, f) for f in FIELDS[:6]), p, spec)
    return int(out.dropped), int(rebin_peak("cpu")), out


@pytest.mark.parametrize("k", [8, 16])
def test_demand_peak_on_a_planted_overfull_cell(k):
    """K + 3 particles bound for one cell, K from the plane below and 3
    from the next row: 3 dropped at the plane stage, the peak K + 3."""
    p, spec = small_spec(k)
    lay = empty_layout(spec)
    rng = np.random.default_rng(1)
    z, r, x = spec.n0 // 2, spec.n1 // 2, spec.n2 // 2
    for i in range(k + 3):
        src = (z - 1, r, x) if i < k else (z, r + 1, x)
        place_particle(lay, spec, i % k, src, (z, r, x), rng)
    dropped, peak, out = rebinned(lay, p, spec)
    assert (dropped, peak) == (3, k + 3)
    c = r * spec.X + x
    assert int(out.occ[z, :, c].sum()) == k


@pytest.mark.parametrize("k", [8, 16])
def test_demand_peak_counts_an_intermediate_stage(k):
    """overflow_layout's stage-2 case: K + 1 particles seek one cell in
    the in-row stage though the final cells have room; one is dropped and
    the peak reads K + 1."""
    p, spec = small_spec(k)
    lay, _ = overflow_layout(spec, 2)
    assert rebinned(lay, p, spec)[:2] == (1, k + 1)


def test_demand_peak_at_k_drops_nothing_and_is_a_running_max():
    p, spec = small_spec(16)
    lay = empty_layout(spec)
    rng = np.random.default_rng(2)
    z, r, x = spec.n0 // 2, spec.n1 // 2, spec.n2 // 2
    for i in range(16):
        place_particle(lay, spec, i, (z, r, x + 1), (z, r, x), rng)
    assert rebinned(lay, p, spec)[:2] == (0, 16)
    d = layout_state(empty_layout(spec))
    tdense.rebin(d, *(getattr(d, f) for f in FIELDS[:6]), p, spec)
    assert int(rebin_peak("cpu")) == 16      # an empty rebin keeps the max


def test_fluid_step_records_its_spans():
    sim = FluidSimulation.from_scene("dam_break_2d", n_target=200,
                                     substeps=6, device="cpu", dense_k=4,
                                     cell_factor=1.2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.run(6)
    names = [e.name for e in prof.events()]
    for name in ("sph.step", "sph.fluid.density", "sph.fluid.accel",
                 "sph.fluid.integrate"):
        assert names.count(name) == 6, name
    assert names.count("sph.fluid.rebin") == 1
    c = sim.counters()
    assert set(c) == {"dropped", "clamped", "rebin_peak", "pushed"}
    pushed = c.pop("pushed")
    assert pushed.dtype == torch.int64 and pushed.dim() == 0
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in c.values())
    assert int(c["dropped"]) == 0 and int(c["rebin_peak"]) > 0


def test_port_matches_the_plain_reference_on_a_seeded_dam_break():
    """A ~20,000-particle jittered column with the pillar at the
    benchmark's layout (K = 16 and its cell and cadence): two frames of R
    steps (R the rebin cadence), each ending on a rebin, each compared with the reference
    stepped from the frame's start, particles matched by position, within
    the benchmark configuration's limits (ρ included)."""
    with open(bspec.BENCH_DIR / "configs"
              / "dam_break_obstacle_1m.json") as f:
        cfg = json.load(f)
    cfg["n_target"] = 20000
    prog = cfg["program"]
    ph = dam_break_obstacle.build(cfg, 4000000123, "cpu")
    pos = ph.pop("pos")
    assert 19000 < len(pos) < 21000
    keys = ("ndim", "h", "rest_density", "particle_mass", "sound_speed",
            "gamma", "viscosity", "gravity", "dt", "bounds_min",
            "bounds_max", "boundary_damping", "obstacles",
            "obstacle_stiffness")
    params = SPHParams(**{k: ph[k] for k in keys}, dense_k=prog["dense_k"],
                       cell_factor=prog["cell_factor"],
                       rebin_every=prog["rebin_every"], use_pallas=True)
    ph["vmax"] = tdense.rebin_vmax(params, tdense.make_dense_spec(
        params, k=params.dense_k, cell_factor=params.cell_factor))
    every = params.rebin_every
    sim = FluidSimulation(SPHState.from_positions(pos, params), params,
                          substeps=every, device="cpu")
    # Frame 0 from rest; give frame 1 a flow to follow.
    for frame in range(2):
        start = _flat(sim.dstate)
        if frame:
            start["vel"][:, 0] += 0.5
            sim.dstate = sim.dstate.replace_fields(
                vx=torch.where(sim.dstate.occ > 0.5, sim.dstate.vx + 0.5,
                               sim.dstate.vx))
        sim.run(every)
        assert tdense.is_rebin_step(every * frame + every - 1, params)
        got = _flat(sim.dstate)
        r = compare(got, reference.run(start, ph, every), ph)
        assert set(r) == set(cfg["limits"])
        for k, v in r.items():
            assert v <= cfg["limits"][k], (frame, k, r)
    assert int(sim.dstate.step_count) == 2 * every
    assert int(sim.dstate.dropped) == 0


@pytest.mark.parametrize("cf, shape", [(1.38, (145, 16, 7680, 80)),
                                       (1.3, (154, 16, 7680, 80))])
def test_kernel_plans_at_k16_config3(cf, shape):
    """The sweeps' band plan at 16 slots: one block an SM (a one-row band
    alone needs more than half an SM's shared memory), the most rows that
    fit a block; the rebin takes 16-byte code words and refuses K = 12."""
    from sph_tpu_torch.ops import fluid, rebin

    _, p = tscenes.dam_break_3d_obstacle(n_target=1_000_000)
    spec = tdense.make_dense_spec(p, k=16, cell_factor=cf)
    assert (spec.n0, spec.k, spec.C, spec.X) == shape
    plan = fluid.band_plan(spec)
    assert fluid.blocks_per_sm(16) == 1 and fluid.blocks_per_sm(8) == 2
    assert (plan.rows, plan.planes) == (2, 3)
    assert fluid.SMEM_TARGET < fluid._plan(spec, 1).smem_bytes
    assert plan.smem_bytes <= fluid.SMEM_LIMIT
    assert fluid._plan(spec, 3).smem_bytes > fluid.SMEM_LIMIT
    assert fluid.partners(spec) == 431
    rebin.check_spec(spec)
    assert rebin.halo_bytes(spec) == 3 * (rebin.THREADS + 2 * 81) * 16
    with pytest.raises(ValueError, match="K in"):
        rebin.check_spec(dataclasses.replace(spec, k=12))
    with pytest.raises(ValueError, match="K in"):
        fluid.band_plan(dataclasses.replace(spec, k=12))
