"""Port vs reference for the colony's host services: capacity growth
(`resize`, `auto_grow`), genome hot-reload (`on_genome_changed`),
checkpoints (`engine/checkpoint.py`, `Simulation.save`/`load`, across the
two packages both ways), in-run failure handling (`engine/recovery.py`)
and the genome live-edit watcher (`engine/config.py` `SceneWatcher`).

Under rng_mode="hash_sin" both packages initialise every slot bitwise
(tests/test_torch_colony.py), so a resize or a re-init is held bitwise,
the PRNG key aside (JAX carries a split of PRNGKey(seed), the port the key
itself; neither draws from it after init). Stepped states are held as
tests/test_torch_simulation.py holds them. The recovery and watcher tests
mirror tests/test_recovery.py and tests/test_engine.py on the port."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sph_tpu import Simulation as JaxSimulation
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine import checkpoint, config as tconfig
from sph_tpu_torch.engine.recovery import (
    GuardedRun,
    SimulationFault,
    fault_flag,
)
from sph_tpu_torch.engine.simulation import Simulation

from test_torch_simulation import assert_sims_agree, close

torch.set_num_threads(1)


def small_params(jax=False, **kw):
    """tests/test_engine.py's scene: the reference scene at dt 0.5, so
    divisions come every ten steps."""
    cfg = jconfig if jax else tconfig
    base = cfg.reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64)
    return base.replace(**kw) if kw else base


def sim_pair(rng_mode="hash_sin", auto_grow=False, **kw):
    """The JAX Simulation and the port's on the same scene, each built by
    its own package, with the port's key aligned to JAX's."""
    jsim = JaxSimulation(jconfig.reference_genome(), small_params(True, **kw),
                         rng_mode=rng_mode, auto_grow=auto_grow)
    sim = Simulation(tconfig.reference_genome(), small_params(**kw),
                     rng_mode=rng_mode, auto_grow=auto_grow, device="cpu")
    same_key(sim, jsim)
    return sim, jsim


def same_key(sim, jsim):
    """Give the port's state JAX's PRNG key words (read by neither step),
    so whole states compare."""
    sim.state = sim.state.replace_fields(
        rng=torch.from_numpy(np.array(jsim.state.rng)))


def flat(state):
    """The state_to_numpy dict of either package's state."""
    if isinstance(state, ttypes.SimState):
        return ttypes.state_to_numpy(state)
    return jtypes.state_to_numpy(state)


def assert_bitwise(a, b, skip=("rng",)):
    """Every field of two states (either package's) bitwise, dtypes
    included."""
    t, j = flat(a), flat(b)
    assert set(t) == set(j)
    for k in sorted(j):
        if k in skip:
            continue
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def record_resizes(sim):
    """Log (step, new capacity) of every resize that grows the sim."""
    log = []
    resize = sim.resize

    def logged(n):
        before = sim.state.capacity
        resize(n)
        if sim.state.capacity != before:
            log.append((int(sim.state.step_count), sim.state.capacity))

    sim.resize = logged
    return log


# -- capacity growth and genome hot-reload ----------------------------------


def test_resize_matches_jax():
    """ResizeParticleBuffers: old rows kept, new rows freshly initialised,
    bonds/pending/drag/counters/key carried — bitwise, then stepping on."""
    sim, jsim = sim_pair()
    jsim.step(12)
    sim.step(12)
    assert int(sim.state.active_count) == 2
    assert_sims_agree(sim, jsim)
    # From here on the same state in both: carry JAX's across bitwise.
    sim.state = ttypes.state_from_numpy(jtypes.state_to_numpy(jsim.state),
                                        device="cpu")
    jsim.resize(64)
    sim.resize(64)
    assert sim.state.capacity == 64
    assert_bitwise(sim.state, jsim.state, skip=())
    sim.resize(32)                                  # never shrinks
    assert sim.state.capacity == 64
    jsim.step(12)
    sim.step(12)
    assert int(sim.state.active_count) == 4
    assert_sims_agree(sim, jsim)


GROW = dict(capacity=2, max_splits_per_step=4, dt=0.1)


@pytest.fixture(scope="module")
def jax_grown():
    """JAX's auto-grown run: the scene from capacity 2 with up to 4 splits
    a step at dt 0.1 (divisions at steps 51, 101 and 151), 160 steps;
    (its resize log, its state)."""
    jsim = JaxSimulation(jconfig.reference_genome(),
                         small_params(True, **GROW), rng_mode="hash_sin",
                         auto_grow=True)
    log = record_resizes(jsim)
    jsim.step(160)
    return log, jsim.state


@pytest.mark.parametrize("mode", ["bruteforce", "grid"])
def test_auto_grow_matches_jax(jax_grown, mode):
    """The same resizes at the same steps as JAX's (the port checks before
    every step, JAX between scan chunks that cannot span a grow), the
    same population, positions and
    velocities (rtol 1e-4, atol 1e-5·max|x|: measured equal on this CPU).
    Quaternions within 1e-3: the relative-orientation correction axis is
    rounding noise in both packages (tests/test_torch_simulation.py), and
    measured 4.0e-4 apart after these 160 steps. The port runs the grid
    too; JAX's contact reference is its brute force."""
    jlog, jst = jax_grown
    sim = Simulation(tconfig.reference_genome(),
                     small_params(neighbor_mode=mode, **GROW),
                     rng_mode="hash_sin", auto_grow=True, device="cpu")
    log = record_resizes(sim)
    sim.step(160)
    assert log == jlog == [(0, 5), (101, 10), (151, 20)]
    assert sim.state.capacity == jst.capacity == 20
    t, j = flat(sim.state), flat(jst)
    for k in sorted(j):
        name = k.split(".")[-1]
        if name == "rng":
            continue
        if name in ("rot", "rel_orientation", "rot_a", "rot_b"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-3,
                                       err_msg=k)
        elif t[k].dtype.kind == "f":
            close(t[k], j[k], err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert int(sim.state.active_count) == 8


def test_auto_grow_with_variable_dt():
    """The variable-dt path grows at the same steps as the fixed one when
    every dt equals params.dt."""
    a, _ = sim_pair(auto_grow=True, capacity=2, max_splits_per_step=4)
    b, _ = sim_pair(auto_grow=True, capacity=2, max_splits_per_step=4)
    logs = record_resizes(a), record_resizes(b)
    a.step(35)
    b.step(35, dt=b.params.dt)
    assert logs[0] == logs[1] and len(logs[0]) >= 2
    assert torch.equal(a.state.pos, b.state.pos)


def test_on_genome_changed_matches_jax():
    """OnGenomeChanged: a full re-init at the current capacity under the
    new genome, then stepping under it."""
    sim, jsim = sim_pair()
    jsim.step(12)
    sim.step(12)
    mode = dataclasses.replace(jconfig.reference_genome().modes[0],
                               split_interval=3.0,
                               child_a_orientation_yaw=45.0)
    jg = type(jconfig.reference_genome())((mode,))
    tg = tconfig.genome_from_json(jconfig.genome_to_json(jg))
    jsim.on_genome_changed(jg)
    sim.on_genome_changed(tg)
    assert int(sim.state.active_count) == 1 and int(sim.state.step_count) == 0
    assert float(sim.genome.modes[0].split_interval) == 3.0
    assert_bitwise(sim.state, jsim.state)
    same_key(sim, jsim)
    jsim.step(14)
    sim.step(14)
    assert int(sim.state.active_count) == 4
    assert_sims_agree(sim, jsim)


# -- checkpoints ------------------------------------------------------------


def test_checkpoint_roundtrip_bitwise(tmp_path):
    sim = Simulation(tconfig.reference_genome(), small_params(), seed=3,
                     rng_mode="hash_sin", device="cpu")
    sim.step(13)
    path = str(tmp_path / "ckpt.npz")
    sim.save(path)
    sim2 = Simulation.load(path, device="cpu")
    assert sim2.params == sim.params and sim2.genome == sim.genome
    assert (sim2.seed, sim2.rng_mode) == (3, "hash_sin")
    assert_bitwise(sim2.state, sim.state, skip=())
    sim.step(5)
    sim2.step(5)
    assert_bitwise(sim2.state, sim.state, skip=())
    # Grown rows come from the restored stream too.
    sim.resize(32)
    sim2.resize(32)
    assert_bitwise(sim2.state, sim.state, skip=())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A file written by either package loads in the other: every field
    bitwise with its dtype (the key's uint32 words, bools, int32), the
    params, the genome and the sim settings."""
    sim, jsim = sim_pair(neighbor_mode="grid")
    jsim.step(13)
    sim.state = ttypes.state_from_numpy(jtypes.state_to_numpy(jsim.state),
                                        device="cpu")
    path = str(tmp_path / f"{writer}.npz")
    (jsim if writer == "jax" else sim).save(path)
    loaded_t = Simulation.load(path, device="cpu")
    loaded_j = JaxSimulation.load(path)
    for loaded in (loaded_t, loaded_j):
        assert dataclasses.asdict(loaded.params) == \
            dataclasses.asdict(jsim.params)
        assert (loaded.seed, loaded.rng_mode) == (0, "hash_sin")
    assert tconfig.genome_to_json(loaded_t.genome) == \
        jconfig.genome_to_json(jsim.genome)
    assert loaded_t.state.rng.dtype == torch.uint32
    assert_bitwise(loaded_t.state, jsim.state, skip=())
    assert_bitwise(sim.state, loaded_j.state, skip=())
    _, params, genome, meta = checkpoint.load_checkpoint(path, device="cpu")
    assert params == loaded_t.params and genome == loaded_t.genome
    assert meta == {"seed": 0, "rng_mode": "hash_sin"}


# -- in-run failure handling --------------------------------------------------


def with_nan_velocity(state, row=0, col=0, value=np.nan):
    vel = state.vel.clone()
    vel[row, col] = value
    return state.replace_fields(vel=vel)


def nan_injector(at_step):
    """Corrupt one velocity lane once, the first time step_count >= at."""
    fired = []

    def inject(sim, step):
        if not fired and step >= at_step:
            fired.append(step)
            sim.state = with_nan_velocity(sim.state)
    return inject


def make_sim():
    return Simulation(tconfig.reference_genome(), small_params(),
                      device="cpu")


def test_fault_flag_clean_nan_and_overflow():
    sim = make_sim()
    sim.step(3)
    flag = fault_flag(sim.state)
    assert flag.dtype == torch.int32 and flag.shape == () and int(flag) == 0
    assert int(fault_flag(with_nan_velocity(sim.state, 0, 1, np.inf))) == 1
    # Non-finite garbage in INACTIVE rows is not a fault.
    n = int(sim.state.active_count)
    assert int(fault_flag(with_nan_velocity(sim.state, n + 2))) == 0
    over = sim.state.replace_fields(overflow=sim.state.overflow + 1)
    assert int(fault_flag(over)) == 1


def test_halt_restores_last_good_and_dumps(tmp_path):
    sim = make_sim()
    dump = str(tmp_path / "crash.npz")
    guard = GuardedRun(sim, chunk=4, policy="halt", dump_path=dump,
                       inject=nan_injector(at_step=9))
    with pytest.raises(SimulationFault) as ei:
        guard.run(20)
    # Injection arms at the step-12 chunk boundary; the 12 -> 16 chunk
    # faults; restored to 12, bitwise the state of a clean run to 12.
    assert int(sim.state.step_count) == ei.value.good_step == 12
    assert int(fault_flag(sim.state)) == 0
    ref = make_sim()
    ref.step(12)
    assert_bitwise(sim.state, ref.state, skip=())
    post = Simulation.load(dump, device="cpu")
    assert int(fault_flag(post.state)) == 1
    assert ei.value.dump_path == dump
    sim.step(4)
    assert int(fault_flag(sim.state)) == 0


def test_rollback_recovers_transient_fault(tmp_path):
    sim = make_sim()
    guard = GuardedRun(sim, chunk=4, policy="rollback",
                       dump_path=str(tmp_path / "c.npz"),
                       inject=nan_injector(at_step=9))   # fires once
    guard.run(20)
    assert int(sim.state.step_count) == 20
    assert int(fault_flag(sim.state)) == 0
    assert len(guard.faults) == 1
    # The recovered run equals an uninjected one (deterministic step,
    # rollback to the exact chunk boundary).
    ref = make_sim()
    ref.step(20)
    assert_bitwise(sim.state, ref.state, skip=())


def test_rollback_halts_on_permanent_fault():
    sim = make_sim()

    def always_inject(s, step):
        if step >= 8:
            s.state = with_nan_velocity(s.state)

    guard = GuardedRun(sim, chunk=4, policy="rollback", dump_path=None,
                       max_retries=2, inject=always_inject)
    with pytest.raises(SimulationFault, match="reproduced"):
        guard.run(20)
    assert int(sim.state.step_count) == 8    # left at the last good state
    assert len(guard.faults) == 3            # initial + 2 retries
    with pytest.raises(ValueError, match="policy"):
        GuardedRun(sim, policy="retry")


# -- the genome live-edit watcher ------------------------------------------


def test_scene_watcher_fires_on_genome_changed(tmp_path):
    """An edit to the watched JSON re-inits the population on the next
    poll; torn writes are reported, skipped and retried; an unchanged file
    never fires (tests/test_engine.py:89)."""
    params, genome = small_params(), tconfig.reference_genome()
    path = tmp_path / "scene.json"
    tconfig.save_scene(path, params, genome)
    sim = Simulation(genome, params, device="cpu")
    w = tconfig.watch_scene(sim, path)
    sim.step(12)
    assert int(sim.state.active_count) >= 2
    assert w.poll() is False
    assert int(sim.state.active_count) >= 2

    g2 = dataclasses.replace(genome.modes[0], split_interval=9.0)
    tconfig.save_scene(path, params, type(genome)((g2,)))
    os.utime(path, ns=(1, 1))
    assert w.poll() is True
    assert int(sim.state.active_count) == 1
    assert int(sim.state.step_count) == 0
    assert float(sim.genome.modes[0].split_interval) == 9.0

    errs = []
    w.on_error = errs.append
    path.write_text('{"genome": {"modes": [{')
    os.utime(path, ns=(2, 2))
    assert w.poll() is False
    assert len(errs) == 1
    # The fixed file (bare-genome form, as the JAX package writes it)
    # fires on the next poll.
    path.write_text(json.dumps({"modes": [dataclasses.asdict(
        dataclasses.replace(genome.modes[0], split_interval=3.0))]}))
    os.utime(path, ns=(3, 3))
    assert w.poll() is True
    assert float(sim.genome.modes[0].split_interval) == 3.0
