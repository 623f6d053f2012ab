"""Port vs reference, module by module, for the colony's per-cell physics:
quaternions, types and init, pair contact, drag, integration, adhesion,
division and the bond graph. Each test gives the same numpy-seeded inputs
to the sph_tpu function and its sph_tpu_torch counterpart on the CPU.

Tolerances: data movement (init by hash_sin, state conversion, packing of
pending splits, bond rewrites, masks and counters) is bitwise; float math
is held to the JAX twin contract, rtol 1e-5 and atol 1e-6·max|x| — the two
backends may contract a multiply-add or order a sum differently."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.biology import bonds as jbonds
from sph_tpu.biology import division as jdiv
from sph_tpu.core import init as jinit
from sph_tpu.core import quat as jquat
from sph_tpu.core import types as jtypes
from sph_tpu.engine import config as jconfig
from sph_tpu.engine.colony import bonded_colony as jax_bonded_colony
from sph_tpu.physics import adhesion as jadh
from sph_tpu.physics import contact as jcontact
from sph_tpu.physics import drag as jdrag
from sph_tpu.physics import integrate as jintegrate
from sph_tpu_torch.biology import bonds as tbonds
from sph_tpu_torch.biology import division as tdiv
from sph_tpu_torch.core import init as tinit
from sph_tpu_torch.core import quat as tquat
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine import config as tconfig
from sph_tpu_torch.physics import adhesion as tadh
from sph_tpu_torch.physics import contact as tcontact
from sph_tpu_torch.physics import drag as tdrag
from sph_tpu_torch.physics import integrate as tintegrate

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_REL = 1e-6


def close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale,
                               err_msg=err_msg)


def port(jstate) -> ttypes.SimState:
    """The JAX state carried across bitwise, on the CPU."""
    return ttypes.state_from_numpy(jtypes.state_to_numpy(jstate),
                                   device="cpu")


def assert_states(tstate, jstate, exact=(), skip=()):
    """Every field: bitwise for ints/bools and the names in `exact`, the
    twin tolerance for the other floats."""
    t = ttypes.state_to_numpy(tstate)
    j = jtypes.state_to_numpy(jstate)
    assert set(t) == set(j)
    for k in sorted(j):
        if k in skip:
            continue
        assert t[k].dtype == j[k].dtype, k
        assert t[k].shape == j[k].shape, k
        if t[k].dtype.kind != "f" or k in exact:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            close(t[k], j[k], err_msg=k)


def tgenome(g):
    """The port's GenomeDevice (CPU) of a JAX Genome, via its JSON."""
    return tconfig.genome_from_json(jconfig.genome_to_json(g)).to_device(
        "cpu")


def rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# -- quaternions -------------------------------------------------------------


def test_quat_matches_jax():
    rng = np.random.default_rng(0)
    q1, q2 = rand_quats(rng, 64), rand_quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ax = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    T = torch.from_numpy
    close(tquat.mul(T(q1), T(q2)), jquat.mul(q1, q2))
    close(tquat.conjugate(T(q1)), jquat.conjugate(q1))
    close(tquat.rotate(T(q1), T(v)), jquat.rotate(q1, v))
    close(tquat.normalize(T(q1 * 3)), jquat.normalize(q1 * 3))
    close(tquat.from_axis_angle(T(ax), T(ang)),
          jquat.from_axis_angle(ax, ang))
    yaw = rng.uniform(-180, 180, 64).astype(np.float32)
    pitch = rng.uniform(-90, 90, 64).astype(np.float32)
    close(tquat.euler_direction(T(yaw), T(pitch)),
          jquat.euler_direction(yaw, pitch))
    up = rng.normal(size=(64, 3)).astype(np.float32)
    close(tquat.look_rotation(T(v), T(up)), jquat.look_rotation(v, up))
    for a, b in zip(tquat.axis3(T(q1)), jquat.axis3(q1)):
        close(a, b)
    om = rng.normal(size=(64, 3)).astype(np.float32) * 3
    om[:4] = 0.0                      # below angle_eps: unchanged
    close(tquat.integrate_angular(T(q1), T(om), 1 / 60),
          jquat.integrate_angular(q1, om, 1 / 60))


# -- types, config, init -----------------------------------------------------


def test_state_zeros_and_conversion_match_jax():
    p = jtypes.SimParams(capacity=16, max_bonds=32, max_splits_per_step=4)
    tp = ttypes.SimParams(**dataclasses.asdict(p))
    js = jtypes.SimState.zeros(16, p, seed=7)
    ts = ttypes.SimState.zeros(16, tp, seed=7, device="cpu")
    assert_states(ts, js, exact=tuple(jtypes.state_to_numpy(js)))
    # Bitwise round trip of a JAX state through the port and back.
    back = ttypes.state_to_numpy(port(js))
    for k, v in jtypes.state_to_numpy(js).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert ttypes.formatted_id(3, 12, 1) == jtypes.formatted_id(3, 12, 1)


def test_config_json_crosses_packages(tmp_path):
    jg, jp = jconfig.reference_genome(), jconfig.reference_scene_params(
        capacity=64, neighbor_mode="dense")
    tg = tconfig.genome_from_json(jconfig.genome_to_json(jg))
    tp = tconfig.params_from_json(jconfig.params_to_json(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tconfig.genome_to_json(tg) == jconfig.genome_to_json(jg)
    assert tconfig.genome_to_json(tconfig.reference_genome()) == \
        jconfig.genome_to_json(jg)
    path = tmp_path / "scene.json"
    tconfig.save_scene(path, tp, tg)
    jp2, jg2 = jconfig.load_scene(path)
    assert jp2 == jp and jconfig.genome_to_json(jg2) == \
        jconfig.genome_to_json(jg)
    jg_dev, tg_dev = jg.to_device(), tg.to_device("cpu")
    for f in dataclasses.fields(jtypes.GenomeDevice):
        np.testing.assert_array_equal(
            getattr(tg_dev, f.name).numpy(),
            np.asarray(getattr(jg_dev, f.name)), err_msg=f.name)


def test_init_hash_sin_bitwise():
    g = jconfig.reference_genome()
    p = jconfig.reference_scene_params(capacity=512, min_radius=1.0)
    tp = ttypes.SimParams(**dataclasses.asdict(p))
    js = jinit.init_particles(p, g.to_device(), n_modes=3, initial_mode=1,
                              capacity=512, active_count=300,
                              rng_mode="hash_sin")
    ts = tinit.init_particles(tp, None, n_modes=3, initial_mode=1,
                              capacity=512, active_count=300,
                              rng_mode="hash_sin", device="cpu")
    # rng: JAX carries a split of its key; the port keeps PRNGKey(seed).
    assert_states(ts, js, exact=("pos", "radius", "drag", "mass",
                                 "inertia"), skip=("rng",))


def test_init_random_mode_distributions():
    p = ttypes.SimParams(capacity=4096, min_radius=1.0, max_radius=2.0)
    st = tinit.init_particles(p, None, n_modes=2, initial_mode=1,
                              capacity=4096, seed=3, device="cpu")
    r = st.pos.norm(dim=-1)
    assert float(r.max()) <= p.spawn_radius * 1.1 + 1e-4
    assert torch.equal(st.pos[0], torch.zeros(3))
    assert 1.0 <= float(st.radius.min()) and float(st.radius.max()) <= 2.0
    assert 0.5 <= float(st.drag.min()) and float(st.drag.max()) <= 1.0
    assert int(st.mode[0]) == 1 and set(st.mode.tolist()) <= {0, 1}
    assert st.uid[0] == 0 and int(st.active_count) == 1


# -- pair contact, drag, integration ------------------------------------------


def random_state(n=48, seed=0, spread=4.0):
    """A JAX SimState of n live cells packed close enough to touch."""
    rng = np.random.default_rng(seed)
    p = jtypes.SimParams(capacity=n, max_bonds=16, max_splits_per_step=4,
                         spawn_radius=6.0, min_radius=1.5, max_radius=2.5)
    st = jtypes.SimState.zeros(n, p).replace_fields(
        pos=jnp.asarray(rng.uniform(-spread, spread, (n, 3)), jnp.float32),
        vel=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        ang_vel=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        rot=jnp.asarray(rand_quats(rng, n)),
        radius=jnp.asarray(rng.uniform(1.5, 2.5, n), jnp.float32),
        mass=jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32),
        inertia=jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32),
        drag=jnp.asarray(rng.uniform(0.5, 1.0, n), jnp.float32),
        torque_accum=jnp.asarray(rng.normal(size=(n, 3)) * 0.1,
                                 jnp.float32),
        active_count=jnp.int32(n - 5),
    )
    return st, p


def test_pair_contact_and_bruteforce_match_jax():
    js, p = random_state()
    ts = port(js)
    jf, jt = jcontact.contact_forces_bruteforce(js, p)
    tf, tt = tcontact.contact_forces_bruteforce(ts, p)
    assert float(np.abs(np.asarray(jf)).max()) > 1.0   # pairs do touch
    close(tf, jf)
    close(tt, jt)
    out_j = jcontact.apply_contact(js, p, jf, jt)
    out_t = tcontact.apply_contact(ts, p, torch.tensor(np.asarray(jf)),
                                   torch.tensor(np.asarray(jt)))
    assert_states(out_t, out_j)


def test_drag_and_integration_match_jax():
    js, p = random_state(seed=1, spread=8.0)   # some cells outside R
    js = js.replace_fields(drag_input=jtypes.DragInput(
        selected_slot=jnp.int32(3), target=jnp.asarray([1.0, 2.0, 3.0]),
        strength=jnp.float32(100.0)))
    ts = port(js)
    assert_states(tdrag.apply_drag_force(ts, p),
                  jdrag.apply_drag_force(js, p))
    jm = jintegrate.update_motion(js, p)
    tm = tintegrate.update_motion(ts, p)
    assert bool(np.any(np.linalg.norm(np.asarray(js.pos), axis=-1)
                       > p.spawn_radius))
    assert_states(tm, jm)
    assert_states(tintegrate.update_rotation(tm, p),
                  jintegrate.update_rotation(jm, p))


# -- adhesion -----------------------------------------------------------------


def shaken_colony(n=200, seed=0, **kw):
    """A small JAX bonded colony with randomised velocities, spins and
    rotations, so every adhesion constraint is loaded."""
    st, p, g = jax_bonded_colony(n, seed=seed, **kw)
    rng = np.random.default_rng(seed)
    st = st.replace_fields(
        vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32),
        ang_vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32),
        rot=jnp.asarray(rand_quats(rng, n)))
    return st, p, g


def test_adhesion_matches_jax():
    js, p, g = shaken_colony()
    ts = port(js)
    jdv, jdq = jadh.bond_deltas(js, p, g.to_device())
    tdv, tdq = tadh.bond_deltas(ts, p, tgenome(g))
    assert float(np.abs(np.asarray(jdq)).max()) > 0
    close(tdv, jdv)
    close(tdq, jdq)
    assert_states(tadh.apply_adhesion(ts, p, tgenome(g)),
                  jadh.apply_adhesion(js, p, g.to_device()))


def test_segment_sum_sorted_is_segment_sum_order():
    """Rows summed left to right per segment from +0, drops discarded:
    bitwise a sequential scatter-add in row order."""
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(300, 7)).astype(np.float32)
    seg = rng.integers(0, 60, 300)          # ids ≥ 50 are dropped
    got = tadh.segment_sum_sorted(torch.from_numpy(rows),
                                  torch.from_numpy(seg), 50).numpy()
    want = np.zeros((50, 7), np.float32)
    for r, s in zip(rows, seg):
        if s < 50:
            want[s] = want[s] + r
    np.testing.assert_array_equal(got, want)


# -- division ------------------------------------------------------------------


def dividing_colony():
    """A 64-cell JAX colony in a 96-slot state with 12 cells about to
    divide (and more ready than max_splits_per_step allows)."""
    js, p, g = shaken_colony(64, seed=2, max_splits_per_step=8)
    n, cap = 64, 96
    p = p.replace(capacity=cap)
    big = jtypes.SimState.zeros(cap, p)

    def grow(a_big, a):
        return a_big.at[:n].set(a) if a_big.ndim and a_big.shape[0] == cap \
            else a

    fields = {}
    for f in dataclasses.fields(jtypes.SimState):
        if f.name in ("bonds", "pending", "drag_input", "rng"):
            continue
        fields[f.name] = grow(getattr(big, f.name), getattr(js, f.name))
    timer = np.zeros(cap, np.float32)
    timer[np.arange(2, 50, 4)] = 4.995      # ready after one dt
    fields["split_timer"] = jnp.asarray(timer)
    js = big.replace_fields(**fields, bonds=js.bonds)
    return js, p, g


def test_division_matches_jax():
    js, p, g = dividing_colony()
    ts = port(js)
    jg, tg = g.to_device(), tgenome(g)
    jq = jdiv.queue_splits(js, p, jg)
    tq = tdiv.queue_splits(ts, p, tg)
    assert int(jq.pending.count) == 8
    assert_states(tq, jq)
    jd = jdiv.process_pending_splits(jq, p, jg)
    td = tdiv.process_pending_splits(port(jq), p, tg)
    assert int(jd.active_count) == 72
    assert_states(td, jd, exact=("pos", "vel", "rot"))


def test_capacity_caps_division_like_jax():
    js, p, g = dividing_colony()
    js = js.replace_fields(active_count=jnp.int32(92))   # 4 slots free
    jq = jdiv.queue_splits(js, p, g.to_device())
    tq = tdiv.queue_splits(port(js), p, tgenome(g))
    assert_states(tq, jq)
    assert int(jq.pending.count) == 4
    jd = jdiv.process_pending_splits(jq, p, g.to_device())
    td = tdiv.process_pending_splits(port(jq), p, tgenome(g))
    assert int(td.active_count) == 96
    assert_states(td, jd, exact=("pos", "vel", "rot"))


# -- bond graph ------------------------------------------------------------------


def test_classify_zone_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(256, 3)).astype(np.float32)
    b = rng.normal(size=(256, 3)).astype(np.float32)
    q = rand_quats(rng, 256)
    yaw = rng.uniform(-180, 180, 256).astype(np.float32)
    pitch = rng.uniform(-90, 90, 256).astype(np.float32)
    T = torch.from_numpy
    np.testing.assert_array_equal(
        tbonds.classify_zone(T(a), T(q), T(b), T(yaw), T(pitch), 25.0),
        np.asarray(jbonds.classify_zone(a, q, b, yaw, pitch, 25.0)))


def test_bond_upkeep_matches_jax():
    """update_bond_zones on young bonds and filter_bonds on a dirty table,
    then the settled gates: both skip and return the table unchanged."""
    js, p, g = shaken_colony(150, seed=4)
    B = js.bonds.capacity
    created = np.full(B, -10, np.int32)
    created[: B // 3] = 4                       # young, some get anchors
    js = js.replace_fields(
        step_count=jnp.int32(5),
        bonds=js.bonds.replace_fields(
            created_step=jnp.asarray(created),
            anchors_set=js.bonds.anchors_set.at[: B // 6].set(False)))
    ts = port(js)
    jz = jbonds.update_bond_zones(js, p, g.to_device())
    tz = tbonds.update_bond_zones(ts, p, tgenome(g))
    assert_states(ts.replace_fields(bonds=tz), js.replace_fields(bonds=jz))
    # A duplicate same-zone bond per cell so the prune removes something.
    b = jz
    n_act = int(np.sum(np.asarray(b.active)))
    dup = np.arange(n_act, 2 * n_act) % B
    b = b.replace_fields(
        active=b.active.at[dup].set(True),
        slot_a=b.slot_a.at[dup].set(b.slot_a[:n_act]),
        slot_b=b.slot_b.at[dup].set((b.slot_b[:n_act] + 1) % 150),
        zone_a=b.zone_a.at[dup].set(b.zone_a[:n_act]),
        zone_b=b.zone_b.at[dup].set(b.zone_b[:n_act]),
        created_step=b.created_step.at[dup].set(3))
    js2 = js.replace_fields(bonds=b)
    jf = jbonds.filter_bonds(js2)
    tf = tbonds.filter_bonds(port(js2))
    assert int(np.sum(np.asarray(jf.active))) < int(np.sum(
        np.asarray(b.active)))
    np.testing.assert_array_equal(tf.active.numpy(), np.asarray(jf.active))
    settled = js.replace_fields(step_count=jnp.int32(40))
    ts2 = port(settled)
    assert tbonds.update_bond_zones(ts2, p, tgenome(g)) is \
        ts2.bonds
    assert tbonds.filter_bonds(ts2) is ts2.bonds


@pytest.mark.parametrize("zone", [0, 1, 2])
@pytest.mark.parametrize("keep", [(True, True), (True, False),
                                  (False, True), (False, False)])
def test_handle_cell_split_matches_jax(zone, keep):
    js, p, g = shaken_colony(40, seed=6)
    b = js.bonds
    # Parent 7's bonds all take `zone` on the parent's end; fill the table
    # nearly full so the ZoneC duplicates run out of free rows.
    touch_a = np.asarray(b.uid_a) == 7
    touch_b = np.asarray(b.uid_b) == 7
    za = np.where(touch_a, zone, np.asarray(b.zone_a))
    zb = np.where(touch_b, zone, np.asarray(b.zone_b))
    B = b.capacity
    act = np.asarray(b.active).copy()
    n_act = int(act.sum())
    act[n_act: B - 1] = True                      # one free row left
    b = b.replace_fields(zone_a=jnp.asarray(za, jnp.int32),
                         zone_b=jnp.asarray(zb, jnp.int32),
                         active=jnp.asarray(act))
    rot = js.rot
    args = (7, 40, 41, 7, 39, keep[0], keep[1], True, 12)
    jb, jdrop = jbonds.handle_cell_split(b, rot, *args)
    tb, tdrop = tbonds.handle_cell_split(
        port(js.replace_fields(bonds=b)).bonds, torch.tensor(
            np.asarray(rot)), *args)
    assert int(tdrop) == int(jdrop)
    for f in dataclasses.fields(jtypes.BondTable):
        t, j = getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name))
        if t.dtype.kind == "f":
            close(t, j, err_msg=f.name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f.name)
