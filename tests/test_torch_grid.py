"""Port vs reference for the sort+gather grid path: `ops/grid.py` (binning,
bins, the sorted layout, both candidate builders, the colony's grid
contact sums), the grid fluid path of `sph/model.py` (config[0]:
`compute_density`, `compute_accel`, `sph_step`, `make_sph_step` and the
brute-force twins) and the colony step with neighbor_mode="grid".

Tolerances: binning, bins, sort orders and candidates are data movement
and held bitwise. Sums are held to the JAX twin contract, rtol 1e-5 and
atol 1e-6·max|x|, against the jitted JAX function (its eager and jitted
results differ by XLA's multiply-add contraction). The pressure and the
state after several steps carry the Tait pow's last-ulp differences (see
`eos_pressure`), amplified by the `− 1`: their tolerances are stated where
they are used. The colony steps are held as tests/test_torch_simulation.py
holds the dense colony."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu import Simulation as JaxSimulation
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu.engine.step import make_step_fn
from sph_tpu.ops import grid as jgrid
from sph_tpu.sph import model as jmodel
from sph_tpu.sph import scenes as jscenes
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.engine.step import step as tstep
from sph_tpu_torch.ops import LAUNCHES, grid as tgrid, reset_launches
from sph_tpu_torch.physics import contact as tcontact
from sph_tpu_torch.sph import model as tmodel
from sph_tpu_torch.sph import scenes as tscenes
from sph_tpu_torch.utils.convert import sph_state_from_numpy

from test_torch_simulation import assert_sims_agree, carried

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_REL = 1e-6


def close(got, want, rtol=RTOL, atol_rel=ATOL_REL, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale,
                               err_msg=err_msg)


def spec(dim=8, cell=4.0, K=8):
    r = dim * cell / 2
    return jgrid.GridSpec(dim=(dim, dim, dim), cell_size=cell,
                          origin=(-r, -r, -r), cell_capacity=K)


def tspec_of(s):
    return tgrid.GridSpec(**dataclasses.asdict(s))


def positions(n, seed, spread=15.0):
    """Numpy positions in ±spread, with a NaN, ±inf, a huge coordinate and
    points on cell edges in the first rows."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pos[0] = (np.nan, 1.0, 2.0)
    pos[1] = (np.inf, -np.inf, 0.0)
    pos[2] = (1e30, -1e30, np.nan)
    pos[3] = (-16.0, 4.0, 12.0)            # exactly on edges
    pos[4] = (15.999999, -4.0, -0.0)
    return pos


# -- ops/grid.py: binning, bins, sorted layout, candidates (bitwise) ---------


def test_cell_coords_and_ids_bitwise():
    s = spec()
    pos = positions(256, seed=0)
    jc = np.asarray(jgrid.cell_coords(jnp.asarray(pos), s))
    tc = tgrid.cell_coords(torch.from_numpy(pos), tspec_of(s))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), jc)
    # NaN → cell 0 (XLA converts NaN to 0 before the clip); ±inf clip.
    np.testing.assert_array_equal(tc[:3].numpy(),
                                  [[0, 4, 4], [7, 0, 4], [7, 0, 0]])
    np.testing.assert_array_equal(
        tgrid.cell_ids(tc, tspec_of(s)).numpy(),
        np.asarray(jgrid.cell_ids(jnp.asarray(jc), s)))
    # The conversion itself, at the interior bounds of the dense layouts.
    q = torch.tensor([np.nan, np.inf, -np.inf, 3.7, 0.5, -0.5])
    assert tgrid.cell_index(q, 1, 5).tolist() == [1, 5, 1, 3, 1, 1]
    assert tgrid.cell_index(q, 0, 5).tolist() == [0, 5, 0, 3, 0, 0]


BIN_CASES = {
    # name: (n, alive, grid dim, K, spread): random over a 4³ grid (the
    # outside clamped into its edge cells) with dead rows and full cells;
    # everything piled into a few cells of an 8³ grid.
    "random": (200, 170, 4, 4, 15.0),
    "pile": (64, 64, 8, 2, 3.0),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_build_bins_and_sort_by_cell_bitwise(case):
    n, n_alive, dim, K, spread = BIN_CASES[case]
    s = spec(dim=dim, K=K)
    pos = positions(n, seed=1, spread=spread)
    alive = np.arange(n) < n_alive
    jb = jgrid.build_bins(jnp.asarray(pos), jnp.asarray(alive), s)
    tb = tgrid.build_bins(torch.from_numpy(pos), torch.from_numpy(alive),
                          tspec_of(s))
    assert int(tb.overflow) == int(jb.overflow) > 0
    for f in ("idx", "counts", "overflow"):
        a, b = getattr(tb, f), np.asarray(getattr(jb, f))
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)

    jorder, jsb = jgrid.sort_by_cell(jnp.asarray(pos), s)
    torder, tsb = tgrid.sort_by_cell(torch.from_numpy(pos), tspec_of(s))
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    for f in ("starts", "counts", "overflow"):
        a, b = getattr(tsb, f), np.asarray(getattr(jsb, f))
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert int(tsb.overflow) > 0


@pytest.mark.parametrize("builder", ["bins", "sorted"])
def test_stencil_candidates_bitwise(builder):
    s = spec(dim=6, K=4)
    pos = positions(150, seed=2, spread=12.0)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    if builder == "bins":
        alive = np.arange(150) < 140
        jb = jgrid.build_bins(jp, jnp.asarray(alive), s)
        tb = tgrid.build_bins(tp, torch.from_numpy(alive), tspec_of(s))
        jfn, tfn = jgrid.stencil_candidates, tgrid.stencil_candidates
    else:
        _, jb = jgrid.sort_by_cell(jp, s)
        _, tb = tgrid.sort_by_cell(tp, tspec_of(s))
        jfn = jgrid.stencil_candidates_sorted
        tfn = tgrid.stencil_candidates_sorted
    jc = jgrid.cell_coords(jp, s)
    want = np.asarray(jfn(jc, jb, s))
    got = tfn(torch.tensor(np.asarray(jc)), tb, tspec_of(s))
    assert got.dtype == torch.int32 and got.shape == (150, 27 * 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


# -- ops/grid.py: the colony's grid contact sums ------------------------------


def random_state(n, params, seed=0, spread=15.0):
    """tests/test_grid.py's random contact state, drawn with numpy: (JAX
    state, port state) with a few dead slots."""
    rng = np.random.default_rng(seed)
    js = jtypes.SimState.zeros(n, params).replace_fields(
        pos=jnp.asarray(rng.uniform(-spread, spread, (n, 3)), jnp.float32),
        vel=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        ang_vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.5, jnp.float32),
        radius=jnp.full(n, 2.0, jnp.float32),
        mass=jnp.ones(n, jnp.float32),
        inertia=jnp.ones(n, jnp.float32),
        active_count=jnp.int32(n - 4),
    )
    return js, ttypes.state_from_numpy(jtypes.state_to_numpy(js),
                                       device="cpu")


CONTACT_CASES = {
    # name: (n, cell_capacity, seed, spread) — tests/test_grid.py's scenes:
    # spread out, and piled into a few cells (stresses K and the mask).
    "spread": (256, 32, 0, 15.0),
    "clump": (128, 128, 3, 3.0),
}


@pytest.mark.parametrize("case", sorted(CONTACT_CASES))
def test_contact_forces_grid_matches_jax(case):
    n, K, seed, spread = CONTACT_CASES[case]
    params = jtypes.SimParams(capacity=n, grid_dim=8, grid_cell_size=4.0,
                              cell_capacity=K, spawn_radius=16.0)
    tparams = ttypes.SimParams(**dataclasses.asdict(params))
    js, ts = random_state(n, params, seed=seed, spread=spread)
    jf, jt, jovf = jax.jit(jgrid.contact_forces_grid, static_argnums=1)(
        js, params)
    tf, tt, tovf = tgrid.contact_forces_grid(ts, tparams)
    assert int(tovf) == int(jovf) == 0
    assert float(np.abs(np.asarray(jf)).max()) > 1.0       # real contacts
    close(tf, jf)
    close(tt, jt)
    # The grid equals the brute-force sums (contact reach 2 ≤ cell 4), as
    # tests/test_grid.py holds JAX; dead rows get exactly zero.
    bf, bt = tcontact.contact_forces_bruteforce(ts, tparams)
    np.testing.assert_allclose(tf.numpy(), bf.numpy(), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), bt.numpy(), atol=1e-4)
    assert not tf[n - 4:].any() and not tt[n - 4:].any()


def test_contact_forces_grid_row_blocking():
    """Blocks of 32 rows (the last padded) against one block, and against
    JAX's blocks of 32 (tests/test_grid.py:127)."""
    params = jtypes.SimParams(capacity=100, grid_dim=8, grid_cell_size=4.0,
                              cell_capacity=32, spawn_radius=16.0)
    tparams = ttypes.SimParams(**dataclasses.asdict(params))
    js, ts = random_state(100, params, seed=5)
    f1, t1, _ = tgrid.contact_forces_grid(ts, tparams, row_block=100)
    f2, t2, _ = tgrid.contact_forces_grid(ts, tparams, row_block=32)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-6)
    jf, jt, _ = jgrid.contact_forces_grid(js, params, row_block=32)
    close(f2, jf)
    close(t2, jt)
    assert [len(r) for r in tgrid.row_blocks(100, 32, "cpu")] == [32] * 4


# -- sph/model.py: the grid fluid path (config[0]) ----------------------------

SCENES = {"2d": ("dam_break_2d", 500), "3d": ("dam_break_3d", 400)}


def fluid_pair(name):
    """(JAX state, port state, JAX params, port params) of one scene, from
    the same numpy lattice, with a velocity field so viscosity counts."""
    scene, n = SCENES[name]
    js, jp = getattr(jscenes, scene)(n_target=n)
    ts, tp = getattr(tscenes, scene)(n_target=n)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(tp.grid_spec()) == \
        dataclasses.asdict(jp.grid_spec())
    vel = np.sin(np.asarray(js.pos) * 5.0).astype(np.float32)
    if jp.ndim == 2:
        vel[:, 2] = 0.0
    js = js.replace_fields(vel=jnp.asarray(vel))
    ts = dataclasses.replace(ts, vel=torch.from_numpy(vel))
    return js, ts, jp, tp


def with_density(js, ts, jp):
    """Both states with JAX's grid density and its EOS pressure."""
    rho, _ = jax.jit(jmodel.compute_density, static_argnums=1)(js, jp)
    p = jmodel.eos_pressure(rho, jp)
    js = js.replace_fields(density=rho, pressure=p)
    ts = dataclasses.replace(ts, density=torch.tensor(np.asarray(rho)),
                             pressure=torch.tensor(np.asarray(p)))
    return js, ts


@pytest.mark.parametrize("name", sorted(SCENES))
def test_density_and_accel_match_jax(name):
    js, ts, jp, tp = fluid_pair(name)
    jrho, jovf = jax.jit(jmodel.compute_density, static_argnums=1)(js, jp)
    trho, tovf = tmodel.compute_density(ts, tp)
    assert int(tovf) == int(jovf) == 0
    close(trho, jrho)
    js, ts = with_density(js, ts, jp)
    jacc = jax.jit(jmodel.compute_accel, static_argnums=1)(js, jp)
    tacc = tmodel.compute_accel(ts, tp)
    close(tacc, jacc)
    # The brute-force twins against JAX's, and the grid against them at
    # tests/test_sph.py's tolerances.
    jrho_b = jax.jit(jmodel.compute_density_bruteforce, static_argnums=1)(
        js, jp)
    trho_b = tmodel.compute_density_bruteforce(ts, tp)
    close(trho_b, jrho_b)
    np.testing.assert_allclose(trho.numpy(), trho_b.numpy(), rtol=1e-5)
    jacc_b = jax.jit(jmodel.compute_accel_bruteforce, static_argnums=1)(
        js, jp)
    tacc_b = tmodel.compute_accel_bruteforce(ts, tp)
    close(tacc_b, jacc_b)
    np.testing.assert_allclose(tacc.numpy(), tacc_b.numpy(), rtol=2e-4,
                               atol=2e-3)


def assert_fluid_close(ts, js, tait_b, rtol, atol_rel, p_atol_b):
    """Row by row (both keep the cell-sort order): counters exact, the
    fields within rtol and atol_rel·max|x|, the pressure within rtol and
    p_atol_b·B (B the Tait stiffness): dp/dρ = 7B(ρ/ρ0)⁶/ρ0 turns the
    density's twin-tolerance difference into ~10B times it, and the pow's
    last ulp adds ~1e-6·B (tests/test_torch_model.py)."""
    assert int(ts.step_count) == int(js.step_count)
    assert int(ts.bin_overflow) == int(js.bin_overflow)
    assert ts.step_count.dtype == ts.bin_overflow.dtype == torch.int32
    for f in ("pos", "vel", "density"):
        close(getattr(ts, f), getattr(js, f), rtol=rtol, atol_rel=atol_rel,
              err_msg=f)
    np.testing.assert_allclose(ts.pressure.numpy(), np.asarray(js.pressure),
                               rtol=rtol, atol=p_atol_b * tait_b,
                               err_msg="pressure")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sph_step_matches_jax(name):
    """One step: the output in sorted order, row for row; pressure within
    1e-5·B."""
    js, ts, jp, tp = fluid_pair(name)
    jout = jax.jit(jmodel.sph_step, static_argnums=1)(js, jp)
    tout = tmodel.sph_step(ts, tp)
    order, _ = tgrid.sort_by_cell(ts.pos, tp.grid_spec())
    assert not torch.equal(order, torch.arange(len(order)))   # reordered
    assert_fluid_close(tout, jout, tp.tait_b, RTOL, ATOL_REL, 1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_make_sph_step_10_steps_matches_jax(name):
    """Ten steps through make_sph_step (config[0]'s scene cut to 500
    particles, and the 3D one), from a JAX SPHState carried across as
    numpy arrays. Ten steps compound each pass's twin tolerance; measured
    on this CPU: 3D velocity 1.02e-5·max|v|, density 5.3e-7·max, pressure
    2.9e-6·B (2D: 1.5e-8, 2.5e-7, 0). Held at rtol 1e-4, atol 1e-4·max|x|
    and 1e-4·B."""
    js, _, jp, tp = fluid_pair(name)
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(jmodel.SPHState)}
    ts = sph_state_from_numpy(arrays, device="cpu")
    assert ts.step_count.dtype == torch.int32
    jout = jmodel.make_sph_step(jp, donate=False, substeps=10)(js)
    tout = tmodel.make_sph_step(tp, substeps=10, device="cpu")(ts)
    assert int(tout.step_count) == 10
    assert_fluid_close(tout, jout, tp.tait_b, 1e-4, 1e-4, 1e-4)


# -- the colony step with neighbor_mode="grid" -------------------------------


def test_colony_grid_steps_match_jax():
    """The reference scene on the grid (tests/test_grid.py:160-184): 24
    steps with divisions at steps 11 and 21, from JAX's initial state, and
    no kernel launched."""
    genome = jconfig.reference_genome()
    params = jconfig.reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64, neighbor_mode="grid")
    jsim = JaxSimulation(genome, params)
    tst, tp, tg = carried(jsim, params, genome)
    sim = Simulation(tg, tp, device="cpu")
    sim.state = tst
    reset_launches()
    jsim.step(24)
    sim.step(24)
    assert not any(LAUNCHES.values())
    assert int(sim.state.active_count) == 4
    assert_sims_agree(sim, jsim)


def test_bonded_colony_grid_matches_jax():
    """A 512-cell bonded colony on the grid (bench.py's grid rung at 512
    cells), compressed ×0.8 so contacts fire: 5 steps against JAX's."""
    kw = dict(max_splits_per_step=16, neighbor_mode="grid", grid_dim=16,
              grid_cell_size=4.0, cell_capacity=16)
    jst, jp, jg = jax_bonded_colony(512, **kw)
    jst = jst.replace_fields(pos=jst.pos * 0.8)
    tst, tp, tg = carried(jst, jp, jg)
    f = make_step_fn(jp, donate=False)
    jnext = jst
    for _ in range(5):
        jnext = f(jnext, jg.to_device())
    tnext = tst
    for _ in range(5):
        tnext = tstep(tnext, tp, tg.to_device("cpu"))
    tf, _, tovf = tgrid.contact_forces_grid(tst, tp)
    assert int(tovf) == 0 and float(tf.abs().max()) > 1.0
    assert int(tnext.overflow) == int(jnext.overflow) == 0
    t, j = ttypes.state_to_numpy(tnext), jtypes.state_to_numpy(jnext)
    for k in ("pos", "vel", "ang_vel"):
        close(t[k], j[k], rtol=1e-4, atol_rel=1e-5, err_msg=k)
    np.testing.assert_array_equal(t["bonds.active"], j["bonds.active"])


def test_grid_overflow_surfaced_in_sim_state():
    """tests/test_grid.py:137 on the port: cell_capacity 1 with everyone
    in one cell counts the overflow into SimState.overflow, as JAX does."""
    from sph_tpu_torch.core.init import init_particles
    from sph_tpu_torch.engine.config import (
        reference_genome,
        reference_scene_params,
    )

    params = reference_scene_params(capacity=32).replace(
        neighbor_mode="grid", cell_capacity=1, max_splits_per_step=4,
        max_bonds=16)
    st = init_particles(params, reference_genome().to_device("cpu"),
                        n_modes=1, initial_mode=0, capacity=32,
                        active_count=32, device="cpu")
    st = st.replace_fields(pos=st.pos * 0.01)
    st = tstep(st, params, reference_genome().to_device("cpu"))
    assert int(st.overflow) >= 31
