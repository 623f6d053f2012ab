"""Port vs reference for the colony's dense contact path
(physics/contact_dense.py and the wrappers of K4, K5 and the slot
bookkeeping's two kernels on the CPU, where they run their plain
versions).

- The pack (cell ids, stable sort with payload, ranks, placement) is held
  BITWISE to the JAX package's `_pack_args`, with the XLA column scatters
  (expand=False) and with the Pallas expand kernel in interpret mode
  (expand=True) — the function K5 replaces.
- The sweep is held to JAX's `_sweep_xla` (the XLA twin that the JAX
  package's own tests hold to the Pallas kernel `contact_sweep_pallas`)
  at rtol 1e-5 and atol 1e-6·max|x| on every slot.
- The slots kernel's rank rule (a look-back of at most K ids,
  utils/verify.py `rank_lookback`) is held bitwise to the plain
  `_rank_and_slots` on its edge cases; the slot wrappers' CPU route is the
  plain functions, their argument checks refuse what the kernels do not
  take, and a CPU colony step launches no kernel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.core import types as jtypes
from sph_tpu.physics import contact_dense as jcd
from sph_tpu_torch.core import types as ttypes
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.ops import LAUNCHES, launch_counts, reset_launches
from sph_tpu_torch.ops import contact_slots as ocs
from sph_tpu_torch.ops.contact import SLOT_COUNTS, contact_sweep
from sph_tpu_torch.ops.expand import expand_rows
from sph_tpu_torch.physics import contact_dense as tcd
from sph_tpu_torch.utils.verify import SLOT_CASES, rank_lookback, slot_case

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_REL = 1e-6


def close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale,
                               err_msg=err_msg)


def blob(n=400, k=4, seed=3, radius=9.0, spawn=10.0, alive=None):
    """n cells in a ball (cube-root radial law), spinning and moving: the
    JAX package's expand-verify scene, drawn with numpy. Returns (JAX
    state, port state, params)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = radius * rng.uniform(size=(n, 1)) ** (1 / 3)
    p = jtypes.SimParams(capacity=n, spawn_radius=spawn,
                         neighbor_mode="dense", dense_k=k, max_bonds=8,
                         max_splits_per_step=4)
    js = jtypes.SimState.zeros(n, p).replace_fields(
        pos=jnp.asarray(u * r, jnp.float32),
        vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.5, jnp.float32),
        ang_vel=jnp.asarray(rng.normal(size=(n, 3)) * 0.5, jnp.float32),
        radius=jnp.asarray(rng.uniform(1.6, 2.0, n), jnp.float32),
        active_count=jnp.int32(n if alive is None else alive),
    )
    ts = ttypes.state_from_numpy(jtypes.state_to_numpy(js), device="cpu")
    return js, ts, p


def specs(p):
    js = jcd.make_contact_spec(p, k=p.dense_k,
                               cell_factor=p.dense_cell_factor)
    ts = tcd.make_contact_spec(p, k=p.dense_k,
                               cell_factor=p.dense_cell_factor)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tcd.contact_variants(ts) == jcd.contact_variants(js)
    return js, ts


@pytest.mark.parametrize("expand", [False, True])
def test_pack_bitwise(expand):
    js, ts, p = blob(alive=380)
    jspec, tspec = specs(p)
    assert jspec.slots % 512 == 0            # the Pallas expand path runs
    jf, jocc, jslot, jovr = jcd._pack_args(js, jspec, expand=expand)
    tf, tocc, tslot, tovr = tcd._pack_args(ts, tspec, expand=expand)
    assert int(tovr) == int(jovr) > 0
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    for i, (a, b) in enumerate(zip(tf, jf)):
        # Bitwise, −0 included.
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32),
                                      err_msg=f"field {i}")


def test_pack_bitwise_with_nan_and_inf_positions():
    """ROADMAP C1 at the colony site: NaN and ±inf coordinates bin as
    XLA's convert-then-clip bins them (NaN → the interior's first cell,
    ±inf → its edges), so the pack equals JAX's `_pack_args` (its default
    XLA column scatters) bit for bit. JAX's Pallas expand route
    (expand=True, interpret mode) is no reference here: with these inputs
    it writes NaN into 260 further slots of the rows' tile (measured),
    where its scatter route and the port place the one row."""
    js, _, p = blob(alive=380)
    pos = np.asarray(js.pos).copy()
    pos[5] = (np.nan, 1.0, 2.0)
    pos[6] = (np.inf, -np.inf, 0.5)
    pos[7] = (0.5, np.nan, -np.inf)
    js = js.replace_fields(pos=jnp.asarray(pos))
    ts = ttypes.state_from_numpy(jtypes.state_to_numpy(js), device="cpu")
    jspec, tspec = specs(p)
    np.testing.assert_array_equal(tcd._cell_ids(ts, tspec).numpy(),
                                  np.asarray(jcd._cell_ids(js, jspec)))
    jf, jocc, jslot, jovr = jcd._pack_args(js, jspec)
    tf, tocc, tslot, tovr = tcd._pack_args(ts, tspec)
    assert int(tovr) == int(jovr)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    for i, (a, b) in enumerate(zip(tf, jf)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32),
                                      err_msg=f"field {i}")
    assert bool(tf[0].isnan().any())


def test_expand_wrapper_is_scatter_sorted():
    """The K5 wrapper on CPU tensors returns the plain placement."""
    _, ts, p = blob(n=400, k=4, seed=3)
    spec = specs(p)[1]
    rows, flat, fits, key, _, _ = tcd._sort_with_payload(ts, spec)
    out = expand_rows(rows, key, tcd.PACK_FILLS, spec)
    planes = tcd._scatter_sorted(rows.unbind(1), tcd.PACK_FILLS, flat, fits,
                                 spec)
    assert out.shape == (11, spec.slots)
    for c, plane in enumerate(planes):
        assert torch.equal(out[c], plane.reshape(-1)), c


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sweep_matches_xla_twin(k):
    js, ts, p = blob(n=400, k=k, seed=k)
    jspec, tspec = specs(p)
    jf, jocc, _, _ = jcd._pack_args(js, jspec)
    fields = [torch.tensor(np.asarray(f)) for f in jf]
    occ = torch.tensor(np.asarray(jocc))
    want = jcd._sweep_xla(
        jf, lambda *a: jcd.contact_pair_terms(p, *a), 6, jspec)
    got = contact_sweep(fields, occ, p, tspec)
    assert float(np.abs(np.asarray(want[0])).max()) > 1.0   # real contacts
    for c, (a, b) in enumerate(zip(got, want)):
        close(a, b, err_msg=f"component {c}")


def test_contact_forces_dense_matches_jax():
    js, ts, p = blob(n=400, k=2, seed=7, alive=390)
    jf, jt, jovr = jcd.contact_forces_dense(js, p)
    for use_kernels in (False, True):
        tf, tt, tovr = tcd.contact_forces_dense(
            ts, p.replace(use_pallas=use_kernels))
        assert int(tovr) == int(jovr) > 0         # overflow counted
        close(tf, jf)
        close(tt, jt)
    # Overflowed and dead rows get exactly zero.
    assert np.all(np.asarray(jt)[390:] == 0) and np.all(tt[390:].numpy() == 0)


def test_out_of_domain_binning_matches_jax():
    """Cells past the spawn sphere (division children before the boundary
    clamp) bin into the nearest interior edge cell, never a margin."""
    js, ts, p = blob(n=64, k=2, seed=11)
    pos = np.asarray(js.pos).copy()
    pos[:8] *= 3.0                      # far outside ±spawn_radius
    pos[8] = (1e4, -1e4, 35.0)
    js = js.replace_fields(pos=jnp.asarray(pos))
    ts = ts.replace_fields(pos=torch.tensor(pos))
    jspec, tspec = specs(p)
    jcid = np.asarray(jcd._cell_ids(js, jspec))
    tcid = tcd._cell_ids(ts, tspec).numpy()
    np.testing.assert_array_equal(tcid, jcid)
    x = tcid % tspec.nx_pad
    y = tcid // tspec.nx_pad % tspec.ny
    z = tcid // (tspec.nx_pad * tspec.ny)
    assert x.min() >= 1 and x.max() <= tspec.nx - 2
    assert z.min() >= 1 and z.max() <= tspec.nz - 2
    assert y.min() >= 1
    jf, jt, _ = jcd.contact_forces_dense(js, p)
    tf, tt, _ = tcd.contact_forces_dense(ts, p)
    close(tf, jf)
    close(tt, jt)


def test_screen_and_skip_are_bitwise_invisible():
    """The K4 skip rule on the plain version: dropping every pair term
    whose screen margin is ≤ 0 leaves the sums' bits unchanged."""
    _, ts, p = blob(n=300, k=2, seed=5)
    spec = specs(p)[1]
    fields, occ, _, _ = tcd._pack_args(ts, spec)
    full = tcd._sweep_plain(
        fields, lambda *a: tcd.contact_pair_terms(p, *a), 6, spec)
    F = torch.stack(fields)
    accs = [torch.zeros_like(occ) for _ in range(6)]
    for dz, dy, o in tcd.contact_variants(spec):
        q = torch.roll(F, (-dz, -dy, -o), (1, 2, 3)).unbind(0)
        hit = tcd.contact_screen(p, fields[0], fields[1], fields[2],
                                 fields[9], q[0], q[1], q[2], q[9]) > 0
        ts_ = tcd.contact_pair_terms(p, *fields, *q)
        accs = [torch.where(hit, a + t, a) for a, t in zip(accs, ts_)]
    for a, b in zip(accs, full):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((full[0] != 0).any())


@pytest.mark.parametrize("case", SLOT_CASES)
@pytest.mark.parametrize("k", SLOT_COUNTS)
def test_slot_lookback_is_the_plain_bookkeeping(k, case):
    """The slots kernel's rule, min(rank, K) from a look-back of at most K
    ids, gives `_rank_and_slots`' five outputs bit for bit."""
    _, ts, p = blob(n=8, k=k, spawn=16.0)
    spec = specs(p)[1]
    cid_s, order = slot_case(spec, case, seed=k,
                             n=1 if case == "one row" else 5000)
    want = tcd._rank_and_slots(cid_s, order, spec)
    got = rank_lookback(cid_s, order, spec)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("k", SLOT_COUNTS)
def test_slot_wrappers_take_the_plain_route_on_the_cpu(k):
    """On CPU tensors the slots and gather wrappers return the plain
    functions' bits, and the pack and the contact forces through them
    equal the plain route's, with overflow and dead rows."""
    _, ts, p = blob(n=400, k=k, seed=k, alive=380)
    spec = specs(p)[1]
    plain = tcd._sort_with_payload(ts, spec)
    routed = tcd._sort_with_payload(ts, spec, kernel=True)
    for a, b in zip(routed, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(plain[4]) > 0
    fields, occ, slot_of, overflow = tcd._pack_args(ts, spec)
    comps = [c.reshape(-1) for c in contact_sweep(fields, occ, p, spec)]
    dropped = slot_of.clone()
    dropped[::7] = spec.slots
    comps[2][-1] = float("nan")
    comps[3][-1] = -0.0
    for s_of in (slot_of, dropped):
        want = tcd.gather_back(comps, s_of, overflow)
        got = ocs.gather_back(comps, s_of, overflow)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert got[2] is overflow
    want = tcd.contact_forces_dense(ts, p.replace(use_pallas=False), spec)
    got = tcd.contact_forces_dense(ts, p.replace(use_pallas=True), spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[0].abs().max()) > 1.0


def _slot_operands():
    _, ts, p = blob(n=64, k=2, seed=1)
    spec = specs(p)[1]
    cid_s, order = torch.sort(tcd._cell_ids(ts, spec), stable=True)
    planes = [torch.zeros(spec.slots) for _ in range(6)]
    slot_of = torch.zeros(64, dtype=torch.int32)
    return spec, cid_s, order, planes, slot_of


SLOT_REFUSALS = {
    "ids of int64": lambda sp, c, o, pl, s: ocs.rank_and_slots(
        c.long(), o, sp),
    "ids not a vector": lambda sp, c, o, pl, s: ocs.rank_and_slots(
        c[None], o, sp),
    "order of int32": lambda sp, c, o, pl, s: ocs.rank_and_slots(
        c, o.int(), sp),
    "order of another length": lambda sp, c, o, pl, s: ocs.rank_and_slots(
        c, o[:-1], sp),
    "slots past 32 bits": lambda sp, c, o, pl, s: ocs.rank_and_slots(
        c, o, dataclasses.replace(sp, nz=2 ** 20)),
    "five planes": lambda sp, c, o, pl, s: ocs.gather_back(pl[:5], s, None),
    "a plane of float64": lambda sp, c, o, pl, s: ocs.gather_back(
        [pl[0].double(), *pl[1:]], s, None),
    "planes of two lengths": lambda sp, c, o, pl, s: ocs.gather_back(
        [pl[0][:-4], *pl[1:]], s, None),
    "slot_of of int64": lambda sp, c, o, pl, s: ocs.gather_back(
        pl, s.long(), None),
    "slot_of not a vector": lambda sp, c, o, pl, s: ocs.gather_back(
        pl, s[:, None], None),
}


@pytest.mark.parametrize("case", sorted(SLOT_REFUSALS))
def test_slot_wrappers_refuse_bad_operands(case):
    """The operands are checked on the CPU route too, so a caller that
    passes what the kernels do not take fails here, not first on the
    card."""
    with pytest.raises((ValueError, TypeError)):
        SLOT_REFUSALS[case](*_slot_operands())


def test_cpu_colony_step_launches_no_kernel():
    """A dense colony with use_pallas on CPU tensors takes every wrapper's
    plain route: no launch, the slot kernels' counts included."""
    st, p, g = bonded_colony(512, device="cpu", use_pallas=True)
    sim = Simulation(g, p, device="cpu")
    sim.state = st
    reset_launches()
    sim.step(2)
    assert LAUNCHES == launch_counts()
    assert sim.metrics()["active_particles"] == 512
