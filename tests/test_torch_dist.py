"""Port vs reference for the sharded paths (sph_tpu_torch.parallel): the
halo exchanges, the 1D and 2D sharded dense steps, the sharded contact
forces, Simulation(mesh=…), FluidSimulation checkpoints across meshes and
the rank-order policy.

The port's meshes are worlds of torch.distributed ranks over gloo on the
CPU, spawned once per world size for the module (4 and 8 ranks, as the
JAX tests use 4 and 8 of the 8 virtual CPU devices that conftest.py sets
up); each rank runs `torch_dist_ranks.run`, which imports only the port.
The JAX references run here, in the pytest process.

Tolerances: every sharded run of the port is held BITWISE to the port's
single-device run (the argument of parallel/dist.py). Against JAX's
sharded run: occupancy, `dropped`, `clamped` and `step_count` exact over
the whole run; every float of every slot at the JAX twin contract rtol
1e-5, atol 1e-6·max|x| (tests/test_dense.py; the max over occupied slots)
after AGREE_STEPS steps, against JAX's step run op by op: JAX's jitted
step (XLA's FMA contraction) leaves that contract on the clamped
velocities of close pairs, by as much as the port does, and past
AGREE_STEPS the eager run and the port part too (ROADMAP §C,
`tools/compare_dist_twins.py`). The halo exchanges
bitwise. `clamped` is compared with JAX's SHARDED run only: both count
clamps on the halo-padded block, so a clamp in a boundary plane counts on
two ranks (alarm semantics), and the single-device count is lower
whenever such clamps occur. The colony is held to JAX at
tests/test_torch_simulation.py's tolerance.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec

import torch_dist_ranks as ranks
from sph_tpu import Simulation as JaxSimulation
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu.parallel import dist as jdist
from sph_tpu.sph import dense as jdense
from sph_tpu.sph import model as jmodel
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.core.types import SimParams, SimState
from sph_tpu_torch.engine import config as tconfig
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.parallel import dist as pd
from sph_tpu_torch.parallel.launch import spawn
from sph_tpu_torch.physics import adhesion
from sph_tpu_torch.physics.contact_dense import contact_forces_dense
from sph_tpu_torch.sph import dense as tdense
from sph_tpu_torch.sph import model as tmodel
from sph_tpu_torch.utils.convert import colony_from_jax

torch.set_num_threads(1)

FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs")
SPAWN_TIMEOUT = 300.0
# The JAX tests' fabricated multi-slice devices (tests/test_dist.py):
# ranks interleaved across two hosts and presented shuffled.
FAKES = [(4, 1), (0, 0), (6, 1), (2, 0), (5, 0), (1, 1), (7, 0), (3, 1)]


# -- the cases: one numpy scene through both packages ------------------------


class FluidCase:
    """tests/test_dist.py's random fluid (positions, ~0.35 particles a cell
    at cell_factor 1, random velocities that cross shard seams) packed in
    both packages from the same numpy arrays; `n0`/`n1` override the
    spec."""

    def __init__(self, seed, n0=None, n1=None, n0_multiple=None):
        rng = np.random.default_rng(seed)
        n = 400
        pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
        h = float((0.15 * 0.729 / n) ** (1 / 3))
        kw = dict(ndim=3, h=h, particle_mass=1000.0 / n,
                  bounds_min=(0.0, 0.0, 0.0), bounds_max=(1.0, 1.0, 1.0),
                  dt=0.25 * h / 60.0, sound_speed=60.0, viscosity=0.05,
                  dense_k=4, cell_factor=1.3, use_pallas=False,
                  rebin_every=3)
        vel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
        self.jp, self.tp = jmodel.SPHParams(**kw), tmodel.SPHParams(**kw)
        self.jspec = jdense.make_dense_spec(self.jp, k=4, cell_factor=1.3)
        if n0_multiple:
            n0 = -(-self.jspec.n0 // n0_multiple) * n0_multiple
        if n0 is not None:
            self.jspec = dataclasses.replace(self.jspec, n0=n0)
        if n1 is not None:
            self.jspec = dataclasses.replace(self.jspec, n1=n1)
        self.tspec = tdense.DenseSpec(**dataclasses.asdict(self.jspec))
        jst = jmodel.SPHState.from_positions(jnp.asarray(pos), self.jp)
        self.jd0 = jdense.pack(jst.replace_fields(vel=jnp.asarray(vel)),
                               self.jp, self.jspec)
        tst = tmodel.SPHState.from_positions(torch.from_numpy(pos), self.tp)
        self.td0 = tdense.pack(dataclasses.replace(
            tst, vel=torch.from_numpy(vel)), self.tp, self.tspec,
            device="cpu")
        self.n = n

    def job(self, shape, blocks):
        """The rank job: one sharded step call of each size in `blocks`."""
        return dict(shape=shape, params=dataclasses.asdict(self.tp),
                    spec=dataclasses.asdict(self.tspec),
                    state=ranks.dense_numpy(self.td0), blocks=list(blocks))

    def single(self, substeps):
        """The port's single-device run."""
        return ranks.dense_numpy(tdense.make_dense_step(
            self.tp, self.tspec, substeps)(self.td0, 0))

    def jax_single(self, substeps):
        out = jdense.make_dense_step(self.jp, self.jspec, substeps=substeps,
                                     donate=False)(self.jd0)
        return {f.name: np.asarray(getattr(out, f.name))
                for f in dataclasses.fields(out)}

    def jax_eager(self, substeps):
        """JAX's single-device step run op by op (jax.disable_jit)."""
        with jax.disable_jit():
            out = jdense.make_dense_step(self.jp, self.jspec,
                                         substeps=substeps,
                                         donate=False)(self.jd0)
        return {f.name: np.asarray(getattr(out, f.name))
                for f in dataclasses.fields(out)}

    def jax_sharded(self, shape, substeps):
        devs = jax.devices()[:int(np.prod(shape))]
        if len(shape) == 1:
            mesh = JaxMesh(np.array(devs), ("x",))
            out = jdist.make_sharded_dense_step(
                self.jp, self.jspec, mesh, substeps=substeps, donate=False,
            )(jdist.shard_dense_state(self.jd0, mesh))
        else:
            mesh = jdist.make_mesh_2d(shape, devs)
            out = jdist.make_sharded_dense_step_2d(
                self.jp, self.jspec, mesh, substeps=substeps, donate=False,
            )(self.jd0)
        return {f.name: np.asarray(getattr(out, f.name))
                for f in dataclasses.fields(out)}


FLUID = {
    # name: (case, mesh shape, substeps) — tests/test_dist.py's scenes.
    "ring4": (dict(seed=0, n0_multiple=4), (4,), 12),
    "ring8_autopad": (dict(seed=0, n0=20), (8,), 12),
    "mesh2x4": (dict(seed=3), (2, 4), 12),
    "mesh4x2_uneven": (dict(seed=7, n1=40), (4, 2), 6),
}
# Steps over which every float of the port stays within the twin contract
# of JAX's step run op by op, in every case.
AGREE_STEPS = 2


def blocks_of(name):
    """A case's steps as the ranks take them: AGREE_STEPS, then the rest."""
    return (AGREE_STEPS, FLUID[name][2] - AGREE_STEPS)


def fluid_case(name) -> FluidCase:
    return FluidCase(**FLUID[name][0])


def contact_state(seed):
    """tests/test_dist.py's 300-cell random ball (numpy draws): k=4, the
    kernel route (plain versions on the CPU)."""
    n = 300
    params = SimParams(capacity=n, spawn_radius=10.0, neighbor_mode="dense",
                       dense_k=4, use_pallas=True)
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u = u / np.linalg.norm(u, axis=-1, keepdims=True)
    r = 9.0 * rng.uniform(size=(n, 1)) ** (1 / 3)
    st = dataclasses.replace(
        SimState.zeros(n, params, device="cpu"),
        pos=torch.from_numpy((u * r).astype(np.float32)),
        vel=torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32)),
        radius=torch.full((n,), 2.0),
        active_count=torch.tensor(n, dtype=torch.int32))
    return st, params


def division_window():
    """tests/test_dist.py's division window: the 256-cell dense colony
    (k=2, kernels) resized to 320 with 16 armed split timers, built in JAX
    and carried across; 8 steps then split all 16."""
    state, params, genome = jax_bonded_colony(
        256, neighbor_mode="dense", dense_k=2, use_pallas=True,
        max_splits_per_step=32)
    jsim = JaxSimulation(genome, params, auto_grow=False, donate=False,
                         scan_chunk=4)
    jsim.state = state
    jsim.resize(320)
    interval = genome.modes[0].split_interval
    jsim.state = jsim.state.replace_fields(
        split_timer=jsim.state.split_timer.at[:16].set(
            jnp.float32(interval - 2 * params.dt)))
    st, tp, tg = colony_from_jax(
        jtypes.state_to_numpy(jsim.state), dataclasses.asdict(params),
        jconfig.genome_to_json(genome), device="cpu")
    return jsim, st, tp, tg


COLONY_STEPS = 8


@pytest.fixture(scope="module")
def cases():
    out = {name: fluid_case(name) for name in FLUID}
    out["contact"] = contact_state(7)
    out["colony"] = division_window()
    return out


def colony_job(shape, st, tp, tg, **kw):
    return dict(dict(shape=shape, state=ttypes.state_to_numpy(st),
                     params=dataclasses.asdict(tp),
                     genome=tconfig.genome_to_json(tg), steps=COLONY_STEPS),
                **kw)


# The division window with the adhesion plan on, through
# Simulation(scan_chunk=4): 2 chunks through the carried plan and a 2-step
# tail without one.
PLAN_CHUNK, PLAN_STEPS = 4, 10


def _spawn(world, jobs, tmp):
    return spawn(ranks.run, world, "gloo", "cpu", str(tmp / "init"),
                 args=(jobs,), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def halo_input():
    rng = np.random.default_rng(5)
    return dict(arr=rng.normal(size=(8, 2, 64)).astype(np.float32), X=4,
                fill=1.0e9)


@pytest.fixture(scope="module")
def world4(cases, halo_input, tmp_path_factory):
    """One 4-rank world: the halos, the 4-ring fluid, the checkpoints and
    the colony with the adhesion plan on a 4-ring."""
    tmp = tmp_path_factory.mktemp("world4")
    c = cases["ring4"]
    sim = FluidSimulation(*_scene(c), substeps=3, device="cpu")
    path = str(tmp / "start.npz")
    sim.save(path)
    _, cst, ctp, ctg = cases["colony"]
    jobs = [("halos", "halos", halo_input),
            ("ring4", "fluid", c.job((4,), blocks_of("ring4"))),
            ("checkpoints", "checkpoints",
             dict(path=path, dir=str(tmp), steps=3)),
            ("colony_plan_ring4", "colony",
             colony_job((4,), cst, ctp.replace(adhesion_plan="on"), ctg,
                        scan_chunk=PLAN_CHUNK, steps=PLAN_STEPS))]
    return _spawn(4, jobs, tmp), path


def _scene(c: FluidCase):
    """The case's flat state and params for FluidSimulation (the scene's
    own spec: n0 as make_dense_spec gives it, uneven over 4 ranks)."""
    occ = c.td0.occ.reshape(-1) > 0.5
    pos = torch.stack([c.td0.px.reshape(-1), c.td0.py.reshape(-1),
                       c.td0.pz.reshape(-1)], -1)[occ]
    vel = torch.stack([c.td0.vx.reshape(-1), c.td0.vy.reshape(-1),
                       c.td0.vz.reshape(-1)], -1)[occ]
    st = tmodel.SPHState.from_positions(pos, c.tp)
    return dataclasses.replace(st, vel=vel), c.tp


@pytest.fixture(scope="module")
def world8(cases, tmp_path_factory):
    """One 8-rank world: the 8-ring and both 2D meshes of the fluid, the
    contact forces and the colony on a ring and a 4×2 mesh, and the
    rank-order policy on fabricated hosts."""
    tmp = tmp_path_factory.mktemp("world8")
    jobs = [(name, "fluid", cases[name].job(shape, blocks_of(name)))
            for name, (_, shape, _) in FLUID.items() if name != "ring4"]
    st, params = cases["contact"]
    cjob = dict(state=ttypes.state_to_numpy(st),
                params=dataclasses.asdict(params))
    jobs += [("contact_ring8", "contact", dict(cjob, shape=(8,))),
             ("contact_4x2", "contact", dict(cjob, shape=(4, 2)))]
    for shape in ((8,), (2, 4)):
        jobs.append((f"slabs_{shape}", "slabs",
                     cases["mesh2x4"].job(shape, (1,))))
    _, cst, ctp, ctg = cases["colony"]
    jobs += [("colony_ring8", "colony", colony_job((8,), cst, ctp, ctg)),
             ("colony_4x2", "colony", colony_job((4, 2), cst, ctp, ctg)),
             ("order", "order", dict(fakes=FAKES))]
    return _spawn(8, jobs, tmp)


def rank0(world, name):
    """Rank 0's result of a job, after checking that every rank ended with
    the same bits where the job returns a digest."""
    results = [r[name] for r in world]
    if "digest" in results[0]:
        assert len({r["digest"] for r in results}) == 1, name
    return results[0]


def world_of(name, world4, world8):
    return world4[0] if name == "ring4" else world8


# -- halo exchanges -----------------------------------------------------------


def test_exchange_halos_bitwise_to_jax(world4, halo_input):
    arr, X, fill = halo_input["arr"], halo_input["X"], halo_input["fill"]
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("x",))

    def sharded(f, spec):
        return np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False))(jnp.asarray(arr)))

    planes = sharded(lambda a: jdist.exchange_halo(a, "x"),
                     PartitionSpec("x", None, None))
    rows = sharded(lambda a: jdist.exchange_row_halo(a, X, "x", fill),
                   PartitionSpec(None, None, "x"))
    P, C = planes.shape[0] // 4, rows.shape[2] // 4
    for r, res in enumerate(world4[0]):
        got = res["halos"]
        np.testing.assert_array_equal(got["planes"],
                                      planes[r * P:(r + 1) * P])
        np.testing.assert_array_equal(got["rows"],
                                      rows[:, :, r * C:(r + 1) * C])
    # The ring wraps: rank 0's left halo is the last rank's last plane.
    np.testing.assert_array_equal(world4[0][0]["halos"]["planes"][0],
                                  arr[-1])


# -- the sharded dense steps --------------------------------------------------


@pytest.mark.parametrize("name", list(FLUID))
def test_sharded_fluid_bitwise_to_single_device(name, cases, world4, world8):
    c, (_, shape, sub) = cases[name], FLUID[name]
    got = rank0(world_of(name, world4, world8), name)
    for key, steps in (("early", AGREE_STEPS), ("state", sub)):
        want = c.single(steps)
        for f in FIELDS + ("dropped", "step_count"):
            np.testing.assert_array_equal(got[key][f], want[f],
                                          err_msg=f"{key}.{f}")
    # Each rank held a block of whole planes (and, in 2D, whole rows).
    P = -(-c.tspec.n0 // shape[0])
    assert got["block"][0] == P
    if len(shape) == 2:
        assert got["block"][2] == pd.blocks(c.tspec, shape)[1] * c.tspec.X


def outside_twin_tolerance(got, want, occ):
    """Slots where `got` misses `want` by more than rtol 1e-5 plus atol
    1e-6·max|want| over the occupied slots (the JAX twin contract; empty
    slots hold sentinel positions, which would swamp the scale)."""
    scale = float(np.abs(want[occ > 0.5]).max())
    tol = 1e-5 * np.abs(want) + 1e-6 * scale
    return ~(np.abs(got - want) <= tol)


@pytest.mark.parametrize("name", list(FLUID))
def test_sharded_fluid_matches_jax_sharded(name, cases, world4, world8):
    """Against JAX's sharded run: occupancy and the counters (clamped with
    its double count) exact after AGREE_STEPS steps and after the whole
    run. Every float of every slot within the twin tolerance of JAX's step
    run op by op (jax.disable_jit: no XLA fusion, so no FMA contraction)
    after AGREE_STEPS steps. JAX's jitted runs part from that eager run
    beyond the tolerance on the clamped velocities of close pairs from the
    first steps on, by as much as the port does (ROADMAP §C)."""
    c, (_, shape, sub) = cases[name], FLUID[name]
    got = rank0(world_of(name, world4, world8), name)
    want = {key: c.jax_sharded(shape, steps)
            for key, steps in (("early", AGREE_STEPS), ("state", sub))}
    for key in want:
        np.testing.assert_array_equal(got[key]["occ"], want[key]["occ"])
        for f in ("dropped", "clamped", "step_count"):
            assert int(got[key][f]) == int(want[key][f]), (key, f)
    assert int(want["early"]["clamped"]) > 0    # the clamp is on this path
    early, eager = got["early"], c.jax_eager(AGREE_STEPS)
    np.testing.assert_array_equal(early["occ"], eager["occ"])
    for f in ("px", "py", "pz", "vx", "vy", "vz", "rho", "prs"):
        bad = outside_twin_tolerance(early[f], eager[f], early["occ"])
        assert not bad.any(), (f, int(bad.sum()))


@pytest.mark.parametrize("name", list(FLUID))
def test_sharded_fluid_conserves_and_migrates(name, cases, world4, world8):
    """Population conserved, nothing dropped, and particles crossed the
    seams between ranks' blocks along every mesh axis whose real cells span
    more than one block (the uneven 4×2 case's 14 real rows all lie in its
    first block of 24), or the equality tests prove nothing."""
    c, (_, shape, _) = cases[name], FLUID[name]
    out = rank0(world_of(name, world4, world8), name)["state"]
    occ0 = c.td0.occ.numpy()
    assert out["occ"].sum() == occ0.sum() == c.n
    assert int(out["dropped"]) == 0
    P, rows = pd.blocks(c.tspec, shape)
    X = c.tspec.X
    live = np.nonzero(occ0.reshape(occ0.shape[0], occ0.shape[1], -1, X)
                      .any(axis=(0, 1, 3)))[0]
    spans_rows = live.max() // rows > live.min() // rows
    for axis in range(len(shape) if spans_rows else 1):
        def per_block(occ):
            if axis == 0:
                n = -(-occ.shape[0] // P) * P
                occ = np.concatenate([occ, np.zeros((n - occ.shape[0],)
                                                    + occ.shape[1:])])
                return occ.reshape(-1, P, *occ.shape[1:]).sum(
                    axis=(1, 2, 3))
            r = occ.reshape(occ.shape[0], occ.shape[1], -1, X).sum(
                axis=(0, 1, 3))
            r = np.concatenate([r, np.zeros(-len(r) % rows)])
            return r.reshape(-1, rows).sum(1)
        assert (per_block(occ0) != per_block(out["occ"])).any(), axis


def test_wrappers_take_halo_padded_slabs(monkeypatch):
    """The kernels' operand checks (ops/build.slab_planes) take the planes
    from the operands — a [P + 2, K, C] slab, or the 2D local spec's
    rows — and still refuse a wrong K, C or row count, a wrong type and a
    misaligned tensor."""
    from sph_tpu_torch.ops import build
    from sph_tpu_torch.ops import contact as oc
    from sph_tpu_torch.ops import fluid as of
    from sph_tpu_torch.physics import contact_dense as cd

    c = fluid_case("mesh2x4")
    spec = c.tspec
    lspec = pd.local_spec(spec, (2, 4))
    assert lspec.n1 == pd.blocks(spec, (2, 4))[1] + 16 and lspec.C % 128 == 0
    assert of.band_plan(lspec).bands >= 1
    slab = torch.zeros((5, spec.k, spec.C))
    local = torch.zeros((9, spec.k, lspec.C))
    assert build.slab_planes("density_sweep", (slab,) * 4,
                             (spec.k, spec.C)) == 5
    assert build.slab_planes("accel_sweep", (local,) * 9,
                             (lspec.k, lspec.C)) == 9
    bad = {"K": torch.zeros((5, spec.k + 2, spec.C)),
           "C": torch.zeros((5, spec.k, spec.C - spec.X)),
           "planes": torch.zeros((4, spec.k, spec.C))}
    for what, t in bad.items():
        with pytest.raises(ValueError, match="shape"):
            build.slab_planes("density_sweep", (slab, t), (spec.k, spec.C))
    with pytest.raises(TypeError, match="float32"):
        build.slab_planes("density_sweep", (slab.double(),),
                          (spec.k, spec.C))
    flat = torch.zeros(slab.numel() + 1)
    with pytest.raises(ValueError, match="aligned"):
        build.slab_planes("density_sweep", (flat[1:].view(slab.shape),),
                          (spec.k, spec.C))
    with pytest.raises(ValueError, match="at least one plane"):
        build.slab_planes("density_sweep", (slab[:0],), (spec.k, spec.C))

    st, params = contact_state(7)
    cspec = cd.make_contact_spec(params, k=4, cell_factor=1.05)
    clocal = dataclasses.replace(cspec, ny=pd.contact_rows(cspec, (4, 2)) + 8)
    lplan = oc.band_plan(clocal)
    assert lplan.bands >= 1
    cslab = torch.zeros((7, clocal.ny, clocal.L))
    assert build.slab_planes("contact_sweep", (cslab,) * 11,
                             (clocal.ny, clocal.L)) == 7
    # The sweep's wrapper hands its one launch the slab's own 7 planes,
    # the local rows and their band plan, with the stream's zeroed band
    # cursor, and returns six planes of the slab's shape (the entry point
    # stands in for the library; the tensors stay on the CPU).
    seen = {}

    def entry(ins, occ_p, outs, cursor, *args):
        seen.update(ins=list(ins), outs=list(outs), cursor=cursor,
                    args=args)
        return 0

    monkeypatch.setattr(oc, "check_device", lambda *a: None)
    monkeypatch.setattr(oc, "stream_of", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    try:
        outs = oc.launch_bands("contact_sweep", entry, (cslab,) * 10, cslab,
                               clocal, lplan, 0.5)
        assert [o.shape for o in outs] == [cslab.shape] * oc.NCOMP
        assert seen["args"] == (7, clocal.ny, clocal.L, clocal.k,
                                lplan.rows, lplan.smem_bytes, 0.5, None, 7)
        assert seen["ins"] == [cslab.data_ptr()] * 10
        assert seen["outs"] == [o.data_ptr() for o in outs]
        cursor = oc._CURSORS[(cslab.device, 7)]
        assert seen["cursor"] == cursor.data_ptr()
        assert cursor.tolist() == [0] * oc.CURSOR_INTS
    finally:
        oc._CURSORS.pop((cslab.device, 7), None)
    with pytest.raises(ValueError, match="shape"):
        build.slab_planes("contact_sweep", (cslab,),
                          (clocal.ny + 8, clocal.L))


def contact_block_reference(x, fill, spec, shape, coords):
    """A rank's halo-padded block of one packed colony plane in numpy:
    planes (and in 2D rows) padded to whole blocks, the block ±1 taken
    around the ring, the row halo framed by 3 sentinel rows a side."""
    planes = -(-spec.nz // shape[0])
    rows = pd.contact_rows(spec, shape)

    def padded(a, axis, n):
        ext = list(a.shape)
        ext[axis] = n - a.shape[axis]
        return np.concatenate([a, np.full(ext, fill, a.dtype)], axis)

    a = padded(x.numpy(), 0, planes * shape[0])
    if rows is not None:
        a = padded(a, 1, rows * shape[1])
        y0 = coords[1] * rows
        a = np.take(a, np.arange(y0 - 1, y0 + rows + 1), 1, mode="wrap")
        side = np.full((a.shape[0], 3, a.shape[2]), fill, a.dtype)
        a = np.concatenate([side, a, side], 1)
    z0 = coords[0] * planes
    return np.take(a, np.arange(z0 - 1, z0 + planes + 1), 0, mode="wrap")


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_verify_slabs_are_the_exchanged_blocks(shape, cases, world8):
    """parallel.dist's mesh-free cuts, which the card's checks and timings
    of K1, K2 and K4 at the sharded shapes use: fluid_slab cuts from the
    global state exactly the blocks that the ranks' exchanges build, and
    contact_block (which the sharded contact forces use) the block of the
    replicated pack that a ring would deliver, with the spec of its
    shape."""
    from sph_tpu_torch.physics import contact_dense as cd

    c = cases["mesh2x4"]
    st, params = cases["contact"]
    cspec = cd.make_contact_spec(params, k=params.dense_k,
                                 cell_factor=params.dense_cell_factor)
    fields, occ, _, _ = cd._pack_args(st, cspec, expand=True)
    for res in world8:
        got = res[f"slabs_{shape}"]
        coords = got["coords"]
        slab, _ = pd.fluid_slab(c.td0, c.tp, c.tspec, shape, coords)
        for f, a in got["fluid"].items():
            np.testing.assert_array_equal(a, getattr(slab, f).numpy(),
                                          err_msg=f)
        block, sspec = pd.contact_block([*fields, occ], cspec, shape,
                                        coords)
        assert len(block) == 11
        for x, b, fill in zip([*fields, occ], block, cd.PACK_FILLS):
            assert b.shape == sspec.shape()
            np.testing.assert_array_equal(
                b.numpy(),
                contact_block_reference(x, fill, cspec, shape, coords))


def test_rebin_offsets_match_jax_on_a_padded_slab(cases):
    """dense.rebin with dim0_offset/dim1_offset equals JAX's rebin on a
    halo-padded block, and with both offsets 0 stays today's rebin."""
    c = cases["mesh2x4"]
    rng = np.random.default_rng(1)
    j, t = c.jd0, c.td0
    # Nudge every particle by up to half a cell so the rebin moves some.
    nudge = {f: (rng.uniform(-0.5, 0.5, t.px.shape) * c.tspec.cell
                 ).astype(np.float32) for f in ("px", "py", "pz")}
    moved = {f: np.where(t.occ.numpy() > 0.5,
                         getattr(t, f).numpy() + nudge[f],
                         getattr(t, f).numpy()) for f in nudge}
    X = c.tspec.X
    # A padded block: planes 3..8 with rows 8..23 of the fused axis.
    z, r0, r1 = slice(3, 9), 8, 24
    cols = slice(r0 * X, r1 * X)

    def block(a):
        return np.ascontiguousarray(a[z, :, cols])

    args = [moved["px"], moved["py"], moved["pz"], t.vx.numpy(),
            t.vy.numpy(), t.vz.numpy()]
    occ = t.occ.numpy()
    # Each slot's ρ and p tagged by its index, so a misplaced one shows.
    tag = np.arange(occ.size, dtype=np.float32).reshape(occ.shape)
    rho = np.where(occ > 0.5, 900.0 + tag % 4099 * 0.125,
                   c.tp.rest_density).astype(np.float32)
    prs = np.where(occ > 0.5, tag % 8191 * 3.0, 0.0).astype(np.float32)
    jd = j.replace_fields(occ=jnp.asarray(block(occ)))
    jo = jdense.rebin(jd, *(jnp.asarray(block(a)) for a in args), c.jp,
                      c.jspec, dim0_offset=3, dim1_offset=r0)
    td = dataclasses.replace(t, occ=torch.from_numpy(block(occ)),
                             rho=torch.from_numpy(block(rho)),
                             prs=torch.from_numpy(block(prs)))
    to = tdense.rebin(td, *(torch.from_numpy(block(a)) for a in args), c.tp,
                      c.tspec, dim0_offset=3, dim1_offset=r0)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    assert int(to.dropped) == int(jo.dropped)
    # ρ and p move with their particles: where JAX's rebin, which leaves
    # them in place, moves velocity planes that carry them.
    jc = jdense.rebin(jd, *(jnp.asarray(block(a))
                            for a in args[:3] + [rho, prs, args[5]]),
                      c.jp, c.jspec, dim0_offset=3, dim1_offset=r0)
    np.testing.assert_array_equal(
        to.rho.numpy(), np.where(np.asarray(jc.occ) > 0.5,
                                 np.asarray(jc.vx), c.tp.rest_density))
    np.testing.assert_array_equal(to.prs.numpy(), np.asarray(jc.vy))
    # Some particle left the block's interior, or the offsets were moot.
    assert not np.array_equal(to.occ.numpy(), block(occ))
    # Offsets 0 on the whole layout: bitwise the default call.
    full = [torch.from_numpy(a) for a in args]
    a = tdense.rebin(t, *full, c.tp, c.tspec)
    b = tdense.rebin(t, *full, c.tp, c.tspec, dim0_offset=0, dim1_offset=0)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "dropped"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- the sharded contact forces and the colony --------------------------------


@pytest.mark.parametrize("name", ["contact_ring8", "contact_4x2"])
def test_sharded_contact_forces_bitwise(name, cases, world8):
    st, params = cases["contact"]
    f1, t1, o1 = contact_forces_dense(st, params)
    assert float(f1.abs().max()) > 0       # the colony really interacts
    for res in world8:
        got = res[name]
        assert got["overflow"] == int(o1)  # 4 of these draws overflow k=4
        np.testing.assert_array_equal(got["force"], f1.numpy())
        np.testing.assert_array_equal(got["torque"], t1.numpy())


@pytest.fixture(scope="module")
def colony_single(cases):
    """The port's single-device run of the division window."""
    _, st, tp, tg = cases["colony"]
    sim = Simulation(tg, tp, device="cpu")
    sim.state = st
    sim.step(COLONY_STEPS)
    return ttypes.state_to_numpy(sim.state)


@pytest.mark.parametrize("name", ["colony_ring8", "colony_4x2"])
def test_sharded_colony_bitwise_to_single_device(name, world8,
                                                 colony_single):
    got = rank0(world8, name)["state"]
    assert int(got["active_count"]) == 256 + 16    # the splits fired
    assert int(got["overflow"]) == 0
    for k in colony_single:
        np.testing.assert_array_equal(got[k], colony_single[k], err_msg=k)


def test_sharded_colony_with_a_plan_bitwise_to_single_device(cases,
                                                            world4):
    """Simulation(mesh=4-ring, scan_chunk=4) with the adhesion plan on
    through the division window: every rank bitwise one device's
    Simulation(scan_chunk=4), and both took the planned path (the hybrid
    branch on the division steps)."""
    _, st, tp, tg = cases["colony"]
    adhesion.reset_plan_counts()
    sim = Simulation(tg, tp.replace(adhesion_plan="on"), device="cpu",
                     scan_chunk=PLAN_CHUNK)
    sim.state = st
    sim.step(PLAN_STEPS)
    want = ttypes.state_to_numpy(sim.state)
    counts = dict(adhesion.PLAN_COUNTS)
    assert counts["quiet"] + counts["hybrid"] == 8 and counts["hybrid"] > 0
    r = rank0(world4[0], "colony_plan_ring4")
    assert all(x["colony_plan_ring4"]["plan_counts"] == counts
               for x in world4[0])
    got = r["state"]
    assert int(got["active_count"]) == 256 + 16    # the splits fired
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_colony_matches_jax(cases, world8):
    """Held to JAX's run of the same window at test_torch_simulation.py's
    tolerance (bond table, counts and ids exact; positions, velocities,
    spins rtol 1e-4 and atol 1e-5·max|x|; quaternions atol 1e-4)."""
    jsim = cases["colony"][0]
    jsim.step(COLONY_STEPS)
    j = jtypes.state_to_numpy(jsim.state)
    t = rank0(world8, "colony_ring8")["state"]
    for k in sorted(j):
        name = k.split(".")[-1]
        if name in ("rot", "rel_orientation", "rot_a", "rot_b"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        elif t[k].dtype.kind == "f" and name in (
                "pos", "vel", "ang_vel", "torque_accum", "anchor_a",
                "anchor_b"):
            np.testing.assert_allclose(
                t[k], j[k], rtol=1e-4,
                atol=1e-5 * float(np.abs(j[k]).max()), err_msg=k)
        elif name != "rng":
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# -- FluidSimulation on a mesh ------------------------------------------------


def test_fluid_checkpoints_cross_meshes_both_ways(world4):
    """Saved on the 4-ring and loaded on one device, saved on one device
    and loaded on the ring: every pair steps to bitwise the same state as
    one device stepping from the first checkpoint all along; the ring's
    metrics (over the gathered state) are one device's. `clamped`
    is the alarm count, which the ring's boundary planes count twice: the
    more steps a state took on the ring, the higher it is."""
    results, path = world4
    ref = FluidSimulation.load(path, device="cpu")
    ref.run(6)
    want = ranks.dense_numpy(ref.dstate)
    got = results[0]["checkpoints"]
    for run in ("ring", "ring2", "one"):
        for f in want:
            if f != "clamped":
                np.testing.assert_array_equal(got[run][f], want[f],
                                              err_msg=f"{run}.{f}")
    clamped = [int(got[r]["clamped"]) for r in ("ring", "ring2", "one")]
    assert clamped[0] == clamped[1] > clamped[2] > int(want["clamped"])
    m, mw = got["metrics"], ref.metrics()
    for r in results:
        for k in m:
            if k != "steps_per_sec":
                assert r["checkpoints"]["metrics"][k] == m[k], k
    for k in m:
        if k not in ("steps_per_sec", "clamped"):
            assert m[k] == mw[k], k


def test_fluid_mesh_refuses_drag():
    """Interactive drag stays single-device, as in the JAX package."""
    sim = FluidSimulation.__new__(FluidSimulation)
    sim.mesh, sim.params = object(), fluid_case("ring4").tp
    with pytest.raises(NotImplementedError, match="single-device"):
        sim.set_drag((0.5, 0.5, 0.5), (0.6, 0.5, 0.5))


# -- rank order ---------------------------------------------------------------


def test_rank_order_policy_fabricated_hosts(world8):
    """order_devices_slice_major groups fabricated ranks host-major with
    ascending ranks inside each host (one seam between hosts in the open
    chain), and the mesh builders apply it: tests/test_dist.py's fabricated
    multi-slice case with ranks for devices and hosts for slices."""
    fakes = [pd.RankInfo(r, node) for r, node in FAKES]
    out = pd.order_devices_slice_major(fakes)
    assert [d.node for d in out] == [0] * 4 + [1] * 4
    assert [d.rank for d in out] == [0, 2, 5, 7, 1, 3, 4, 6]
    assert sum(a.node != b.node for a, b in zip(out, out[1:])) == 1
    three = [pd.RankInfo(r, s) for r, s in
             [(0, 2), (1, 1), (2, 0), (3, 2), (4, 1), (5, 0)]]
    assert [d.node for d in pd.order_devices_slice_major(three)] == \
        [0, 0, 1, 1, 2, 2]
    plain = [pd.RankInfo(r, None) for r in (3, 1, 2, 0)]
    assert [d.rank for d in pd.order_devices_slice_major(plain)] == \
        [0, 1, 2, 3]
    node = dict(FAKES)
    for res in world8:
        got = res["order"]
        assert got["ring"] == [0, 2, 5, 7, 1, 3, 4, 6]
        for row in got["grid"]:
            assert len({node[r] for r in row}) == 1
        assert [node[row[0]] for row in got["grid"]] == [0, 1]


def test_spawn_fails_the_run_when_a_rank_raises(tmp_path):
    """A rank that raises fails the whole world (the others, blocked in a
    collective, are stopped), within the time limit."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(ranks.run, 2, "gloo", "cpu", str(tmp_path / "init"),
              args=([("boom", "fail_on_rank", 1)],), timeout=60.0)
