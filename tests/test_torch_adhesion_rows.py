"""The adhesion pass's per-bond row table against the reference: the plain
`bond_rows` (the plain version of kernel A1) against the JAX package's
endpoint gather and `bond_pair_deltas`, the wrapper's route on the CPU,
and each accumulate branch fed by the table against JAX's accumulate fed
the same four deltas.

Tolerances: the rows at the JAX twin contract, rtol 1e-5 and atol
1e-6·max|x| (the backends may contract a multiply-add or order a sum
differently); the pad rows, the rows of invalid bonds and the accumulates
bitwise (they only move, add and select, in JAX's order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu.physics import adhesion as jadh
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine import config as tconfig
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.ops import LAUNCHES, build, reset_launches
from sph_tpu_torch.ops import adhesion as oa
from sph_tpu_torch.physics import adhesion as tadh

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_REL = 1e-6


def close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()),
                               err_msg=err_msg)


def three_modes():
    """The reference genome's mode in three variants of distinct
    adhesion (damping on in two), so uid_A % 3 picks each."""
    m = jconfig.reference_genome().modes[0]
    return jtypes.Genome(tuple(
        dataclasses.replace(m, is_initial=i == 0,
                            adhesion_rest_length=2.96 + 0.3 * i,
                            adhesion_spring_stiffness=200.0 - 40.0 * i,
                            adhesion_spring_damping=3.0 * i,
                            orientation_constraint_strength=0.493 + 0.2 * i)
        for i in range(3)))


@pytest.fixture(scope="module")
def edged():
    """A 300-cell JAX colony of three modes and 1,000 bond rows (so the
    table has pad rows), shaken (random velocities and rotations load
    every constraint), with invalid bonds planted among the active ones:
    slot_a −1, slot_b −1, inactive, and both endpoints on one cell.
    Returns (JAX state, port state, params, JAX genome)."""
    g = three_modes()
    js, p, _ = jax_bonded_colony(300, genome=g, seed=1, max_bonds=1000)
    rng = np.random.default_rng(1)
    n = js.capacity
    q = rng.normal(size=(n, 4)).astype(np.float32)
    b = js.bonds
    live = np.nonzero(np.asarray(b.active))[0]
    slot_a, slot_b = np.asarray(b.slot_a).copy(), np.asarray(b.slot_b).copy()
    active = np.asarray(b.active).copy()
    slot_a[live[::11]] = -1
    slot_b[live[::13]] = -1
    active[live[::17]] = False
    slot_b[live[5::19]] = slot_a[live[5::19]]
    js = js.replace_fields(
        vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32),
        rot=jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        bonds=b.replace_fields(slot_a=jnp.asarray(slot_a),
                               slot_b=jnp.asarray(slot_b),
                               active=jnp.asarray(active)))
    ts = ttypes.state_from_numpy(jtypes.state_to_numpy(js), device="cpu")
    return js, ts, p, g


def tgenome(g):
    return tconfig.genome_from_json(jconfig.genome_to_json(g)).to_device(
        "cpu")


def jax_deltas(js, p, gd, dt):
    """JAX's bond_deltas up to the accumulate: its endpoint gather, its
    spring parameters and bond_pair_deltas, as numpy."""
    b, n = js.bonds, js.capacity
    ia, ib = jnp.clip(b.slot_a, 0, n - 1), jnp.clip(b.slot_b, 0, n - 1)
    valid = b.active & (b.slot_a >= 0) & (b.slot_b >= 0)
    ends = [(js.pos[i], js.vel[i], js.rot[i], js.mass[i]) for i in (ia, ib)]
    return [np.asarray(x) for x in jadh.bond_pair_deltas(
        b, valid, *jadh.bond_spring_params(b, gd), *ends[0], *ends[1], p,
        dt)]


@pytest.mark.parametrize("anchors", [True, False])
def test_bond_rows_equal_jax(edged, anchors):
    js, ts, p, g = edged
    p = dataclasses.replace(p, enable_anchor_constraints=anchors)
    dt = 0.7 * p.dt
    rows = tadh.bond_rows(ts, p, tgenome(g), dt=dt).numpy()
    B = ts.bonds.capacity
    assert rows.shape == (tadh.padded_rows(B), 7)
    assert rows.shape[0] % tadh._SEG_W == 0 and rows.shape[0] > 2 * B
    assert not rows[2 * B:].view(np.int32).any()
    dv_a, dq_a, dv_b, dq_b = jax_deltas(js, p, g.to_device(), dt)
    close(rows[:B], np.concatenate([dv_a, dq_a], 1), "A rows")
    close(rows[B:2 * B], np.concatenate([dv_b, dq_b], 1), "B rows")
    valid = tadh._valid(ts.bonds).numpy()
    assert not rows[:2 * B][~np.concatenate([valid, valid])].view(
        np.int32).any()
    # Every constraint fired, and each of the three modes' bonds.
    uid = ts.bonds.uid_a.numpy()
    for mode in range(3):
        assert np.abs(rows[:B][valid & (uid % 3 == mode), :3]).max() > 0
    assert (np.abs(rows[:2 * B, 3:]).max() > 0) == anchors


def test_wrapper_takes_plain_route_on_cpu(edged):
    _, ts, p, g = edged
    reset_launches()
    got = oa.bond_rows(ts, p, tgenome(g))
    assert torch.equal(got.view(torch.int32),
                       tadh.bond_rows(ts, p, tgenome(g)).view(torch.int32))
    assert LAUNCHES["bond_rows"] == 0
    assert build._LOADED is None


def jax_table(bonds):
    return jtypes.BondTable.empty(bonds.capacity).replace_fields(
        active=jnp.asarray(bonds.active.numpy()),
        slot_a=jnp.asarray(bonds.slot_a.numpy()),
        slot_b=jnp.asarray(bonds.slot_b.numpy()))


@pytest.mark.parametrize("branch, n_rewrite, n_prune", [
    ("plain", 0, 0),
    ("quiet", 0, 300),
    ("hybrid", 60, 40),
    ("full", 2200, 40),
])
def test_each_branch_fed_by_the_row_table_equals_jax(branch, n_rewrite,
                                                     n_prune):
    """bond_deltas on a 2,000-cell colony whose bonds drifted from a plan's
    snapshot (endpoints rewritten, bonds pruned): with no plan (plain) and
    with the stale plan in each branch, bitwise JAX's accumulate of the
    same deltas, which is what the port gave before it read a row table."""
    st, p, g = bonded_colony(2000, device="cpu", seed=2)
    gd = g.to_device("cpu")
    n = st.capacity
    tp = tadh.build_bond_plan(st.bonds, n)
    jp = jax.jit(lambda bb: jadh.build_bond_plan(bb, n))(jax_table(st.bonds))
    rng = np.random.default_rng(3)
    b = st.bonds
    live = np.nonzero(b.active.numpy())[0]
    slot_a, active = b.slot_a.numpy().copy(), b.active.numpy().copy()
    slot_a[rng.choice(live, n_rewrite, replace=False)] = rng.integers(
        0, n, n_rewrite)
    active[rng.choice(live, n_prune, replace=False)] = False
    st = st.replace_fields(bonds=b.replace_fields(
        slot_a=torch.from_numpy(slot_a), active=torch.from_numpy(active)))
    rows = tadh.bond_rows(st, p, gd)
    B = b.capacity
    d = [jnp.asarray(r.numpy()) for r in (rows[:B, :3], rows[:B, 3:],
                                           rows[B:2 * B, :3],
                                           rows[B:2 * B, 3:])]
    jb = jax_table(st.bonds)
    tadh.reset_plan_counts()
    if branch == "plain":
        got = tadh.bond_deltas(st, p, gd)
        seg = [jnp.asarray(s.numpy()) for s in tadh._segments(st.bonds, n)]
        want = jax.jit(lambda *r: jadh.accumulate_bond_deltas(
            *r, *seg, n))(*d)
    else:
        got = tadh.bond_deltas(st, p, gd, plan=tp)
        assert tadh.PLAN_COUNTS[branch] == 1
        want = jax.jit(lambda *r: jadh.accumulate_bond_deltas_hybrid(
            *r, jb, n, jp))(*d)
    for x, y, name in zip(got, want, ("dv", "dq")):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      np.asarray(y).view(np.int32),
                                      err_msg=name)
    assert float(got[0].abs().max()) > 0
