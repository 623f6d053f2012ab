"""Port vs reference for the planned adhesion accumulate: BondPlan,
build_bond_plan, the segmented scan, the planned and hybrid accumulates,
use_bond_plan, run_steps with a carried plan and Simulation's scan_chunk;
and kernel A2's split of the planned accumulate, modelled in plain torch
and held bitwise to the plain planned accumulate, with the A2 wrapper's
CPU route.

The same numpy inputs, made from a seed, go through sph_tpu (jitted, on the
CPU) and sph_tpu_torch. Tolerances: the plan, the scan and the planned and
hybrid sums are bitwise equal to JAX's (they only sort, gather, add and
select, in JAX's order); the plain accumulate is held to JAX's
segment_sum at JAX's own planned-vs-plain tolerance (rtol 2e-5, atol
1e-6, tests/test_adhesion.py). Steps: counts, ids and the bond table
exact; positions, velocities and spins at tests/test_torch_simulation.py's
rtol 1e-4 / atol 1e-5·max|x|, quaternions atol 1e-4."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import sph_tpu.physics.adhesion as jadh
import sph_tpu_torch.physics.adhesion as tadh
from sph_tpu import Simulation as JaxSimulation
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu.engine.step import run_steps as jax_run_steps
from sph_tpu.engine.step import use_bond_plan as jax_use_bond_plan
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.ops import LAUNCHES, build, reset_launches
from sph_tpu_torch.ops import adhesion as oa
from sph_tpu_torch.utils.convert import bond_plan_from_numpy, colony_from_jax
from sph_tpu_torch.utils.verify import END_PLANS, bond_scan_case, end_plan

# The package re-exports the function `step` (as sph_tpu.engine does), which
# shadows the submodule of that name: take the module from the import system.
tstep = importlib.import_module("sph_tpu_torch.engine.step")

torch.set_num_threads(1)

PLAN_FIELDS = [f.name for f in dataclasses.fields(tadh.BondPlan)]


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def assert_bitwise(got, want, err_msg=""):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=err_msg)


def tables(slot_a, slot_b, active):
    """The same bond table in both packages (other columns empty)."""
    B = len(active)
    j = jtypes.BondTable.empty(B).replace_fields(
        active=jnp.asarray(active), slot_a=jnp.asarray(slot_a),
        slot_b=jnp.asarray(slot_b))
    t = ttypes.BondTable.empty(B, device="cpu").replace_fields(
        active=torch.from_numpy(active.copy()),
        slot_a=torch.from_numpy(slot_a.copy()),
        slot_b=torch.from_numpy(slot_b.copy()))
    return j, t


def jax_plan(bonds, n_rows: int):
    return jax.jit(lambda bb: jadh.build_bond_plan(bb, n_rows))(bonds)


def assert_plans_equal(tp, jp):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


def random_deltas(rng, valid):
    """dv_a, dq_a, dv_b, dq_b: normal rows, exact zeros on invalid bonds
    (as bond_pair_deltas gives them), as numpy f32."""
    return [np.where(valid[:, None], rng.normal(size=(len(valid), w)),
                     0.0).astype(np.float32) for w in (3, 4, 3, 4)]


def row_table(d):
    """The port's [Mp, 7] row table (adhesion.bond_rows' layout) of the
    four deltas: [dv_a | dq_a], then [dv_b | dq_b], then zero rows."""
    dv_a, dq_a, dv_b, dq_b = map(torch.from_numpy, d)
    rows = torch.cat([torch.cat([dv_a, dq_a], 1), torch.cat([dv_b, dq_b], 1)])
    pad = tadh.padded_rows(dv_a.shape[0]) - rows.shape[0]
    return torch.cat([rows, torch.zeros((pad, 7))])


# -- the plan -----------------------------------------------------------------


def test_build_bond_plan_equals_jax_on_a_colony():
    """A 3,000-cell bonded colony's table cut to a capacity that leaves
    padding rows (2B not a multiple of 512), with bonds deactivated and
    endpoint slots set to -1."""
    state, _, _ = bonded_colony(3000, device="cpu")
    b = state.bonds
    B = b.capacity - 100
    rng = np.random.default_rng(0)
    active = b.active.numpy()[:B].copy()
    slot_a = b.slot_a.numpy()[:B].copy()
    slot_b = b.slot_b.numpy()[:B].copy()
    live = np.nonzero(active)[0]
    active[rng.choice(live, 400, replace=False)] = False
    slot_a[rng.choice(live, 150, replace=False)] = -1
    slot_b[rng.choice(live, 150, replace=False)] = -1
    jb, tb = tables(slot_a, slot_b, active)
    n = state.capacity
    tp = tadh.build_bond_plan(tb, n)
    assert tp.perm.numel() % tadh._SEG_W == 0 and tp.perm.numel() > 2 * B
    assert tp.perm.dtype == tp.last.dtype == torch.int64
    assert_plans_equal(tp, jax_plan(jb, n))
    assert 0 < int(tp.has.sum()) < n


# -- the segmented scan -------------------------------------------------------


_jax_scan = jax.jit(jadh._blocked_segscan)


def scan_case(n_blocks: int, p_start: float, seed: int, long_run: int):
    """Rows (with −0.0 entries) and run-start flags; `long_run` ≥ 0 clears
    every start from the middle of block long_run − 1 to the middle of
    block long_run + 1, so one run spans that whole block."""
    rng = np.random.default_rng(seed)
    W = tadh._SEG_W
    M = n_blocks * W
    rs = rng.normal(size=(M, 7)).astype(np.float32)
    rs[rng.random((M, 7)) < 0.05] = -0.0
    flags = rng.random(M) < p_start
    flags[0] = True
    if 0 <= long_run < n_blocks:
        lo = max(0, (long_run - 1) * W + W // 2)
        flags[lo + 1:min(M, (long_run + 1) * W + W // 2)] = False
    return rs, flags


def assert_scan_equal(rs, flags):
    want = np.asarray(_jax_scan(jnp.asarray(rs), jnp.asarray(flags)))
    got = tadh._blocked_segscan(torch.from_numpy(rs),
                                torch.from_numpy(flags)).numpy()
    assert_bitwise(got, want)


@settings(max_examples=30, deadline=None)
@given(n_blocks=st.sampled_from([1, 2, 3, 5]),
       p_start=st.sampled_from([0.0005, 0.01, 0.2, 1.0]),
       seed=st.integers(0, 2**31 - 1), long_run=st.integers(-1, 4))
def test_blocked_segscan_equals_jax(n_blocks, p_start, seed, long_run):
    assert_scan_equal(*scan_case(n_blocks, p_start, seed, long_run))


@pytest.mark.parametrize("case", ["one run", "starts at block edges",
                                  "no first start", "block-wide run"])
def test_blocked_segscan_edge_runs_equal_jax(case):
    W = tadh._SEG_W
    rs, flags = scan_case(4, 0.0, 3, -1)
    if case == "starts at block edges":
        flags[::W] = True
        flags[W - 1::W] = True
    elif case == "no first start":
        flags[[0, 700, 1500]] = [False, True, True]
    elif case == "block-wide run":
        flags[[W - 1, 3 * W]] = True
    assert_scan_equal(rs, flags)


# -- the accumulates ----------------------------------------------------------


def random_table(seed: int, N: int = 300, B: int = 6144):
    rng = np.random.default_rng(seed)
    slot_a = rng.integers(-1, N, B).astype(np.int32)
    slot_b = rng.integers(0, N, B).astype(np.int32)
    active = rng.random(B) < 0.7
    return rng, N, slot_a, slot_b, active


def test_planned_accumulate_equals_jax():
    """A fresh plan: the port's planned sum with its own plan and with
    JAX's plan carried across is bitwise JAX's planned sum, and within
    JAX's tolerance of the plain sum."""
    rng, N, slot_a, slot_b, active = random_table(7)
    jb, tb = tables(slot_a, slot_b, active)
    jp, tp = jax_plan(jb, N), tadh.build_bond_plan(tb, N)
    valid = active & (slot_a >= 0) & (slot_b >= 0)
    d = random_deltas(rng, valid)
    want = jax.jit(lambda *r: jadh.accumulate_bond_deltas_planned(*r, jp))(
        *map(jnp.asarray, d))
    carried = bond_plan_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in PLAN_FIELDS}, device="cpu")
    for plan in (tp, carried):
        got = tadh.accumulate_bond_deltas_planned(row_table(d), plan)
        for g, w, name in zip(got, want, ("dv", "dq")):
            assert_bitwise(g.numpy(), w, err_msg=name)
    seg_a, seg_b = tadh._segments(tb, N)
    plain = tadh.accumulate_bond_deltas(row_table(d), seg_a, seg_b, N)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=2e-5,
                                   atol=1e-6)


def drift(rng, slot_a, slot_b, active, n_rewrite, n_new, n_prune, N):
    """The table after a stale plan's snapshot: endpoints rewritten, bonds
    created and bonds pruned (tests/test_adhesion.py's division pattern)."""
    slot_a, slot_b, active = slot_a.copy(), slot_b.copy(), active.copy()
    B = len(active)
    rw = rng.choice(B, n_rewrite, replace=False)
    slot_a[rw] = rng.integers(0, N, n_rewrite)
    active[rng.choice(np.nonzero(~active)[0], n_new, replace=False)] = True
    active[rng.choice(np.nonzero(active)[0], n_prune, replace=False)] = False
    return slot_a, slot_b, active


@pytest.mark.parametrize("branch, n_rewrite, n_new, n_prune", [
    ("quiet", 0, 0, 300),
    ("hybrid", 50, 30, 40),
    ("full", 3000, 30, 40),
])
def test_hybrid_accumulate_with_a_stale_plan_equals_jax(branch, n_rewrite,
                                                        n_new, n_prune):
    """The plan is built before the table drifts. Quiet (pruned bonds
    only), hybrid (rewritten and new bonds, within the side table) and
    full (more than _SIDE_CAP changed): each is bitwise JAX's hybrid sum,
    takes the branch named, and is within JAX's tolerance of the plain
    sum of the drifted table."""
    rng, N, slot_a, slot_b, active = random_table(11)
    jb0, tb0 = tables(slot_a, slot_b, active)
    jp, tp = jax_plan(jb0, N), tadh.build_bond_plan(tb0, N)
    jb, tb = tables(*drift(rng, slot_a, slot_b, active, n_rewrite, n_new,
                           n_prune, N))
    n_changed = int(tadh.plan_changed_count(tb, tp))
    assert n_changed == int(jax.jit(jadh.plan_changed_count)(jb, jp))
    assert (n_changed == 0) == (branch == "quiet")
    assert (n_changed > tadh._SIDE_CAP) == (branch == "full")
    valid = tadh._valid(tb).numpy()
    d = random_deltas(rng, valid)
    want = jax.jit(lambda *r: jadh.accumulate_bond_deltas_hybrid(
        *r, jb, N, jp))(*map(jnp.asarray, d))
    tadh.reset_plan_counts()
    got = tadh.accumulate_bond_deltas_hybrid(row_table(d), tb, N, tp)
    assert tadh.PLAN_COUNTS[branch] == 1
    seg_a, seg_b = tadh._segments(tb, N)
    plain = tadh.accumulate_bond_deltas(row_table(d), seg_a, seg_b, N)
    for g, w, p, name in zip(got, want, plain, ("dv", "dq")):
        assert_bitwise(g.numpy(), w, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=name)


# -- kernel A2's split of the planned accumulate -----------------------------


def a2_split(rows, plan, zero_bond=None):
    """Kernel A2's algorithm (csrc/adhesion.cu) in plain torch, launch by
    launch: (1) a scan block's rows gathered (zeroed for zero_bond's
    bonds) and scanned in-block level by level, each row reading +0 and
    no flag before its block, the block's last row its total, and the
    in-block value and flag kept only at rows that end a run (the rest
    NaN, so a read of one shows); (2) the totals scanned by the same
    levels; (3) a particle's total from its run end, plus the scanned
    total of the block before (+0 for the first), +0 without bonds."""
    W = tadh._SEG_W
    mp = rows.shape[0]
    mb = mp // W
    p = plan.perm
    v = rows[p]
    if zero_bond is not None:
        b = zero_bond.shape[0]
        bond = torch.where(p < b, p, p - b).clamp(0, max(b - 1, 0))
        zero = (p < 2 * b) & zero_bond[bond]
        v = torch.where(zero[:, None], 0.0, v)
    v, f = v.reshape(mb, W, 7), plan.flags.reshape(mb, W)
    t = torch.arange(W)
    d = 1
    while d < W:
        inb = t >= d
        s = torch.where(inb[None, :, None], torch.roll(v, d, 1), 0.0)
        fs = inb[None, :] & torch.roll(f, d, 1)
        v = torch.where(f[..., None], v, v + s)
        f = f | fs
        d *= 2
    tv, tf = v[:, -1].T, f[:, -1]
    ends = torch.cat([plan.flags[1:], torch.ones(1, dtype=torch.bool)])
    v_in = torch.where(ends[:, None], v.reshape(mp, 7), float("nan"))
    f_in = f.reshape(mp) & ends
    i = torch.arange(mb)
    d = 1
    while d < mb:
        inb = i >= d
        s = torch.where(inb[None, :], torch.roll(tv, d, 1), 0.0)
        fs = inb & torch.roll(tf, d, 0)
        tv = torch.where(tf[None, :], tv, tv + s)
        tf = tf | fs
        d *= 2
    j = plan.last
    blk = j // W
    pre = torch.where((blk == 0)[:, None], 0.0, tv[:, (blk - 1).clamp(0)].T)
    x = v_in[j]
    r = torch.where(f_in[j][:, None], x, x + pre)
    r = torch.where(plan.has[:, None], r, 0.0)
    return r[:, :3], r[:, 3:]


A2_CASES = {
    # name: (cells, bonds, seed, active, special, zero_bond)
    "one block": (40, 200, 1, 0.7, False, False),
    "24 blocks": (300, 6144, 2, 0.7, False, False),
    "23 blocks, runs across blocks": (9, 5800, 3, 0.9, False, False),
    "drop run over 4 blocks": (300, 6144, 4, 0.5, False, False),
    "zero_bond": (300, 6144, 5, 0.7, False, True),
    "NaN, inf, -0 rows": (300, 6144, 6, 0.7, True, False),
    "NaN rows and zero_bond": (50, 3000, 7, 0.8, True, True),
    # Every entry −0: the bits show each add of a pad's or a prefix's +0.
    "all -0 rows, runs across blocks": (9, 5800, 10, 0.9, False, False),
    "all -0 rows": (300, 6144, 11, 0.7, False, True),
}


@pytest.mark.parametrize("case", sorted(A2_CASES) + sorted(END_PLANS))
def test_a2_split_equals_the_planned_accumulate(case):
    """The model of A2's split is bitwise the plain planned accumulate
    (the segmented scan and the run-total gather), NaN as NaN, on random
    plans: one block and 23 or 24 (not a power of two), runs crossing
    block edges and spanning several blocks, a drop run of over four
    blocks, a zero_bond mask, NaN, ±inf and −0 rows; and rows of −0 alone
    (the sums then read +0 or −0 by which adds of +0 were made), also on
    utils.verify.END_PLANS."""
    if case in END_PLANS:
        plan = end_plan(case)
        rows = torch.zeros((plan.perm.shape[0], 7))
        special, zero_bond = False, None
    else:
        cells, bonds, seed, active, special, zb = A2_CASES[case]
        _, plan, rows, zero_bond = bond_scan_case(cells, bonds, seed,
                                                  active, special)
        zero_bond = zero_bond if zb else None
    if "all -0" in case:
        rows = torch.full_like(rows, -0.0)
    mb = rows.shape[0] // tadh._SEG_W
    assert (mb == 1) == (case == "one block")
    one = torch.ones(1, dtype=torch.bool)
    run = torch.diff(torch.nonzero(torch.cat([
        one, plan.flags[1:], one]))[:, 0]).max()
    if "over 4" in case:
        assert run > 4 * tadh._SEG_W
    if "across" in case or case in END_PLANS:
        assert run > 2 * tadh._SEG_W
    want = tadh.accumulate_bond_deltas_planned(rows, plan, zero_bond)
    got = a2_split(rows, plan, zero_bond)
    for g, w, name in zip(got, want, ("dv", "dq")):
        assert torch.equal(g.isnan(), w.isnan()), name
        assert_bitwise(g.nan_to_num(0.0).numpy(), w.nan_to_num(0.0).numpy(),
                       err_msg=name)
    if special and zero_bond is None:
        assert bool(got[0].isnan().any() | got[1].isnan().any())
    if "all -0" in case:
        out = torch.cat(got, 1).view(torch.int32)
        assert not bool((out & 0x7FFFFFFF).any())    # ±0 alone
    else:
        assert float(got[0].nan_to_num(0.0).abs().max()) > 0


@pytest.mark.parametrize("zb", [False, True])
def test_bond_scan_takes_plain_route_on_cpu(zb):
    """ops.adhesion.bond_scan on CPU tensors is the plain planned
    accumulate: the same bits, no launch, no kernel library built."""
    _, plan, rows, zero_bond = bond_scan_case(300, 6144, 8, special=True)
    zero_bond = zero_bond if zb else None
    reset_launches()
    got = oa.bond_scan(rows, plan, zero_bond)
    want = tadh.accumulate_bond_deltas_planned(rows, plan, zero_bond)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert LAUNCHES["bond_scan"] == 0
    assert build._LOADED is None


def test_use_bond_plan_threshold_and_modes():
    """Plain at 163,839 bond rows, planned at 163,840 (JAX's threshold),
    and "on"/"off" override both ways, in both packages alike."""
    state, params, _ = bonded_colony(128, device="cpu", dense_k=2)

    def with_cap(cap):
        b = state.bonds
        return state.replace_fields(bonds=ttypes.BondTable(**{
            f.name: torch.cat([getattr(b, f.name), torch.zeros(
                (cap - b.capacity,) + getattr(b, f.name).shape[1:],
                dtype=getattr(b, f.name).dtype)])
            for f in dataclasses.fields(b)}))

    below, at = with_cap(163839), with_cap(163840)
    p_on = dataclasses.replace(params, adhesion_plan="on")
    p_off = dataclasses.replace(params, adhesion_plan="off")
    cases = [(params, below, False), (params, at, True),
             (p_on, below, True), (p_off, at, False)]
    for p, s, want in cases:
        assert tstep.use_bond_plan(p, s) is want
        assert jax_use_bond_plan(p, s) is want   # reads shapes only


# -- steps --------------------------------------------------------------------


def carried(jstate, params, genome):
    return colony_from_jax(jtypes.state_to_numpy(jstate),
                           dataclasses.asdict(params),
                           jconfig.genome_to_json(genome), device="cpu")


def close(got, want, rtol=1e-4, atol_rel=1e-5, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()),
        err_msg=err_msg)


def assert_states_agree(ts, js):
    t = ttypes.state_to_numpy(ts)
    j = jtypes.state_to_numpy(js)
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


@pytest.fixture(scope="module")
def window():
    """check_hybrid_adhesion_division's scene at 256 cells, built in JAX:
    the dense k=2 colony resized to 320 — settled, and with 16 split
    timers armed 3 steps before they fire (the division window); the plan
    on. Returns (settled, armed, params, genome)."""
    state, params, genome = jax_bonded_colony(
        256, neighbor_mode="dense", dense_k=2, use_pallas=True,
        max_splits_per_step=32, adhesion_plan="on")
    jsim = JaxSimulation(genome, params, auto_grow=False, donate=False)
    jsim.state = state
    jsim.resize(320)
    gd = jsim.genome_dev
    armed = jsim.state.replace_fields(
        split_timer=jsim.state.split_timer.at[:16].set(
            jnp.float32(float(gd.split_interval[0]) - 3 * params.dt)))
    return jsim.state, armed, params, genome


# JAX's jitted 8-step run_steps with the plan, compiled once for both
# scenes (they share shapes and params).
_JAX_RUNS: dict = {}


@pytest.mark.parametrize("scene", ["settled", "division window"])
def test_run_steps_with_a_plan_equals_jax(window, scene):
    """run_steps(adhesion_plan="on", return_plan=True), 8 steps: the state
    against JAX's, the returned plan bitwise JAX's; settled, every step
    takes the quiet branch; through the division window (16 splits) the
    hybrid branch runs."""
    settled, armed, params, genome = window
    jst = settled if scene == "settled" else armed
    jgd = genome.to_device()
    if "run8" not in _JAX_RUNS:   # one compile for both scenes
        _JAX_RUNS["run8"] = jax.jit(lambda s, gd: jax_run_steps(
            s, params, gd, 8, return_plan=True))
    jout, jp = _JAX_RUNS["run8"](jst, jgd)
    tst, tparams, tgenome = carried(jst, params, genome)
    tadh.reset_plan_counts()
    tout, tp = tstep.run_steps(tst, tparams, tgenome.to_device("cpu"), 8,
                               return_plan=True)
    assert_states_agree(tout, jout)
    assert_plans_equal(tp, jp)
    counts = dict(tadh.PLAN_COUNTS)
    if scene == "settled":
        assert counts == {"quiet": 8, "hybrid": 0, "full": 0, "builds": 1}
    else:
        assert int(tout.active_count) == 256 + 16
        assert counts["hybrid"] > 0 and counts["full"] == 0, counts


def test_simulation_scan_chunk_equals_jax(window, monkeypatch):
    """Simulation(scan_chunk=4) with the plan on through the division
    window, 10 steps = 2 chunks and a 2-step tail, against JAX's; then a
    resize re-keys the carried plan, and 4 more steps (a chunk) still
    agree. A sim.state of the same capacities whose bonds nearly all
    differ from the plan's snapshot takes the full branch (the side table
    cut to 64 rows: this colony has fewer bonds than _SIDE_CAP) and the
    plan is rebuilt."""
    _, armed, params, genome = window
    jsim = JaxSimulation(genome, params, rng_mode="hash_sin",
                         auto_grow=False, donate=False, scan_chunk=4)
    jsim.state = armed
    tst, tparams, tgenome = carried(armed, params, genome)
    sim = Simulation(tgenome, tparams, rng_mode="hash_sin", device="cpu",
                     scan_chunk=4, donate=False)
    sim.state = tst
    tadh.reset_plan_counts()
    jsim.step(10)
    sim.step(10)
    assert_states_agree(sim.state, jsim.state)
    # 2 chunks of 4 through the plan, the 2-step tail without one.
    assert sum(tadh.PLAN_COUNTS[k] for k in ("quiet", "hybrid",
                                             "full")) == 8
    assert tadh.PLAN_COUNTS["hybrid"] > 0
    assert sim._bond_plan_cap == (320, tparams.max_bonds)
    assert_plans_equal(sim._bond_plan, jsim._bond_plan)

    jsim.resize(384)
    sim.resize(384)
    jsim.step(4)
    sim.step(4)
    assert sim._bond_plan_cap == (384, tparams.max_bonds)
    assert sim._bond_plan.last.shape == (384,)
    assert_states_agree(sim.state, jsim.state)
    assert_plans_equal(sim._bond_plan, jsim._bond_plan)

    # Another colony of the same capacities: its bonds differ from the
    # plan's snapshot almost everywhere.
    other, _, _ = bonded_colony(384, device="cpu", dense_k=2,
                                max_bonds=tparams.max_bonds, seed=3)
    plan = sim._bond_plan
    sim.state = other
    monkeypatch.setattr(tadh, "_SIDE_CAP", 64)
    assert int(tadh.plan_changed_count(other.bonds, plan)) > 64
    tadh.reset_plan_counts()
    sim.step(4)
    assert sim._bond_plan_cap == (384, tparams.max_bonds)
    assert tadh.PLAN_COUNTS["full"] == 1, tadh.PLAN_COUNTS
    assert tadh.PLAN_COUNTS["builds"] == 1
    assert sim._bond_plan is not plan


def test_load_drops_the_plan(tmp_path):
    """A loaded sim carries no plan and has JAX's load-time scan_chunk."""
    st, params, genome = bonded_colony(128, device="cpu", dense_k=2,
                                       adhesion_plan="on")
    sim = Simulation(genome, params, device="cpu", scan_chunk=4)
    sim.state = st
    sim.step(4)
    assert sim._bond_plan is not None
    sim.save(str(tmp_path / "c.npz"))
    back = Simulation.load(str(tmp_path / "c.npz"), device="cpu")
    assert back._bond_plan is None and back.scan_chunk == 64
    back.step(1)
    assert back._bond_plan is None
