"""Port vs reference for the colony slice as a whole: the bonded colony
builder, the Simulation API on the dense contact path (with divisions),
the golden reference trace, pick/drag/metrics, and the entry points'
default device.

The JAX side runs its XLA twins (use_pallas=False); the port runs its
kernel wrappers (use_pallas=True), which take their plain versions on CPU
tensors. Tolerances: counts, ids, zones and flags of the bond table are
exact; positions, velocities and spins after 10 steps are held to rtol 1e-4
and atol 1e-5·max|x| — ten steps compound the twin tolerance (rtol 1e-5) of
each pass (XLA may contract multiply-adds where torch does not);
quaternions to atol 1e-4. The relative-orientation constraint normalises
the correction axis conj(q_a)·q_b·conj(rel) of a settled bond, whose norm is
at rounding level, so that axis is rounding noise in both packages; measured
on the 512-cell colony, the quaternions drift apart by 2e-7 after one step
and 3e-5 after six, where positions stay within 1e-6."""

import dataclasses
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from sph_tpu import Simulation as JaxSimulation
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine import config as tconfig
from sph_tpu_torch.engine.colony import _neighbor_bonds, bonded_colony
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.utils.convert import colony_from_jax

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_scenario_trace.json")


def close(got, want, rtol=1e-4, atol_rel=1e-5, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=err_msg)


def carried(jsim_or_state, params, genome):
    """(port state on the CPU, params, genome) carried across from JAX."""
    st = getattr(jsim_or_state, "state", jsim_or_state)
    return colony_from_jax(jtypes.state_to_numpy(st),
                           dataclasses.asdict(params),
                           jconfig.genome_to_json(genome), device="cpu")


def assert_sims_agree(sim, jsim):
    t = ttypes.state_to_numpy(sim.state)
    j = jtypes.state_to_numpy(jsim.state)
    for k in sorted(j):
        name = k.split(".")[-1]
        if name in ("rot", "rel_orientation", "rot_a", "rot_b"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        elif t[k].dtype.kind == "f" and name in (
                "pos", "vel", "ang_vel", "torque_accum", "anchor_a",
                "anchor_b"):
            close(t[k], j[k], err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    mt, mj = sim.metrics(), jsim.metrics()
    for key in ("step", "active_particles", "bond_count", "overflow"):
        assert mt[key] == mj[key], key
    np.testing.assert_allclose(mt["kinetic_energy"], mj["kinetic_energy"],
                               rtol=1e-3)


def test_bonded_colony_bitwise():
    jst, jp, jg = jax_bonded_colony(2000, max_splits_per_step=64,
                                    dense_k=2)
    tst, tp, tg = bonded_colony(2000, max_splits_per_step=64, dense_k=2,
                                device="cpu")
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tconfig.genome_to_json(tg) == jconfig.genome_to_json(jg)
    t, j = ttypes.state_to_numpy(tst), jtypes.state_to_numpy(jst)
    for k in sorted(j):
        if k == "rng":
            continue
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert int(tst.bonds.active.sum()) > 2000


def test_bonded_colony_cache_hit_equals_cold_build(tmp_path):
    """A build from the on-disk cache is bitwise the cold build: the same
    geometry, and the rng past the jitter draw, so the drag draw agrees."""
    kw = dict(max_splits_per_step=64, dense_k=2, device="cpu")
    cold = ttypes.state_to_numpy(bonded_colony(2000, **kw)[0])
    bonded_colony(2000, cache_dir=tmp_path, **kw)            # miss: writes
    assert len(list(tmp_path.glob("*.npz"))) == 1
    hit = ttypes.state_to_numpy(
        bonded_colony(2000, cache_dir=tmp_path, **kw)[0])
    assert sorted(hit) == sorted(cold)
    for k in sorted(cold):
        assert hit[k].dtype == cold[k].dtype, k
        np.testing.assert_array_equal(hit[k], cold[k], err_msg=k)


def test_neighbor_bonds_order_matches_dict_walk():
    """The vectorised search yields the dict walk's pairs in its order,
    duplicate lattice keys (the later cell wins) included."""
    from sph_tpu.engine.colony import _neighbor_bonds as jax_neighbor_bonds

    rng = np.random.default_rng(0)
    pos = rng.integers(-4, 5, (300, 3)).astype(np.float32) * 2.5
    pos += rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    got = _neighbor_bonds(pos, 2.5)
    want = jax_neighbor_bonds(pos, 2.5)
    assert len(want) > 100
    np.testing.assert_array_equal(got, want)


def colony_pair(n=512, capacity=576, ready=()):
    """A JAX bonded colony of n cells in a `capacity`-slot state (so it
    can divide), with the cells in `ready` one step from splitting; the
    JAX Simulation and the port's on the same state."""
    jst, jp, jg = jax_bonded_colony(n, max_splits_per_step=16, dense_k=2)
    jp = jp.replace(capacity=capacity)
    big = jtypes.SimState.zeros(capacity, jp)
    upd = {}
    for f in dataclasses.fields(jtypes.SimState):
        a, a0 = getattr(big, f.name), getattr(jst, f.name)
        if f.name in ("bonds", "rng", "pending", "drag_input"):
            upd[f.name] = a0 if f.name == "bonds" else a
        elif a.ndim and a.shape[0] == capacity:
            upd[f.name] = a.at[:n].set(a0)
        else:
            upd[f.name] = a0
    timer = np.zeros(capacity, np.float32)
    timer[list(ready)] = 4.995
    upd["split_timer"] = jnp.asarray(timer)
    jst = big.replace_fields(**upd)
    jsim = JaxSimulation(jg, jp)
    jsim.state = jst
    tst, tp, tg = carried(jst, jp, jg)
    sim = Simulation(tg, tp.replace(use_pallas=True), device="cpu")
    sim.state = tst
    return sim, jsim


def test_dense_colony_steps_match_jax():
    sim, jsim = colony_pair()
    sim.step(10)
    jsim.step(10)
    assert sim.metrics()["step"] == 10
    assert_sims_agree(sim, jsim)


def test_dense_colony_division_matches_jax():
    ready = list(range(3, 200, 9))
    sim, jsim = colony_pair(ready=ready)
    bonds0 = sim.metrics()["bond_count"]
    sim.step(4)
    jsim.step(4)
    m = sim.metrics()
    assert m["active_particles"] == 512 + 16          # capped at 16 a step
    assert m["bond_count"] > bonds0
    assert_sims_agree(sim, jsim)
    assert sim.particle_ids() == jsim.particle_ids()


def test_golden_trace():
    """The reference scenario (tools/make_golden_trace.py) from JAX's
    initial state through all 2,400 steps: seven divisions (1 → 128 cells)
    and the settling after each, every 50-step sample against the golden
    file (counts exact; kinetic energy rtol 5e-3 / atol 1e-4, mean radius
    rtol 1e-3, as tests/test_parity_trace.py holds JAX)."""
    golden = json.load(open(GOLDEN))
    p = jconfig.reference_scene_params(capacity=512).replace(
        dt=1 / 60, max_splits_per_step=256, max_bonds=2048)
    jsim = JaxSimulation(jconfig.reference_genome(), p, seed=0)
    tst, tp, tg = carried(jsim, p, jconfig.reference_genome())
    sim = Simulation(tg, tp, device="cpu")
    sim.state = tst
    for want in golden:
        sim.step(50)
        m = sim.metrics()
        n = m["active_particles"]
        assert m["step"] == want["step"]
        assert n == want["n"], m["step"]
        assert m["bond_count"] == want["bonds"], m["step"]
        assert int(sim.state.next_uid) == want["next_uid"]
        np.testing.assert_allclose(m["kinetic_energy"],
                                   want["kinetic_energy"], rtol=5e-3,
                                   atol=1e-4)
        r = float(sim.state.pos[:n].norm(dim=-1).mean())
        np.testing.assert_allclose(r, want["mean_radius_from_origin"],
                                   rtol=1e-3)
    assert sim.metrics()["active_particles"] == 128


def test_pick_drag_and_metrics_match_jax():
    sim, jsim = colony_pair(n=200, capacity=200)
    o, d = (0.0, 0.0, -40.0), (0.0, 0.0, 1.0)
    slot = sim.pick(o, d)
    assert slot == jsim.pick(o, d) and slot >= 0
    assert sim.pick((100.0, 0, 0), (1.0, 0, 0)) == -1
    for s in (sim, jsim):
        s.set_drag(slot, (5.0, 5.0, 5.0), 300.0)
        s.step(3)
        s.clear_drag()
        s.step(1)
    assert_sims_agree(sim, jsim)
    assert int(sim.state.drag_input.selected_slot) == -1
    np.testing.assert_array_equal(sim.forward_axes().round(5),
                                  np.asarray(jsim.forward_axes()).round(5))
    lt, lj = sim.bond_lines(), jsim.bond_lines()
    assert len(lt) == len(lj) > 0
    for a, b in zip(lt[:50], lj[:50]):
        assert (a["color_a"], a["color_b"], a["child_to_child"]) == (
            b["color_a"], b["color_b"], b["child_to_child"])
        close(a["anchor_a"], b["anchor_a"])
    m = sim.metrics()
    assert set(m) == set(jsim.metrics()) and m["steps_per_sec"] != 0


def test_entry_points_default_to_cuda():
    """Entry points run on the card unless the caller passes device='cpu'
    (checked on the signatures: this host has no card)."""
    from sph_tpu_torch.engine.checkpoint import load_checkpoint
    from sph_tpu_torch.sph.dense import pack
    from sph_tpu_torch.sph.model import FluidDrag, make_sph_step
    from sph_tpu_torch.utils import convert

    for fn in (Simulation.__init__, Simulation.load, FluidSimulation.__init__,
               FluidSimulation.from_scene, FluidSimulation.load, pack,
               FluidDrag.at, convert.state_from_numpy,
               convert.sph_state_from_numpy, convert.colony_from_jax,
               bonded_colony, ttypes.state_from_numpy, load_checkpoint,
               make_sph_step):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
