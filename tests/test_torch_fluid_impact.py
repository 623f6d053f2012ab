"""The fluid engine's device-held restart and its count of the lanes an
obstacle pushes, on the CPU (the plain step): `FluidSimulation.snapshot`
and `restore` give back the same steps bitwise; the plain `_integrate`
counts the occupied lanes within h/2 of an obstacle's surface, once a lane,
as the benchmark's plain reference (benchmark/reference/fluid.py) finds
its push acting; and the step sums the count into `ops.obstacle_pushed`,
a running total that `ops.reset_obstacle_pushed` zeroes."""

import math

import pytest
import torch

from benchmark.reference import fluid as reference
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.ops import obstacle_pushed, reset_obstacle_pushed
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.model import SPHParams, SPHState
from sph_tpu_torch.sph.scenes import dam_break_3d

torch.set_num_threads(1)

# A pillar in the column, so the push acts from the first step.
PILLAR = (("cylinder_z", (0.3, 0.15), 0.12),)
STATE_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs",
                "dropped", "clamped", "step_count")


def column_sim():
    st, p = dam_break_3d(2000, obstacles=PILLAR, dense_k=8, cell_factor=1.3,
                         rebin_every=5, use_pallas=False)
    return FluidSimulation(st, p, substeps=5, device="cpu")


def state_of(sim) -> dict:
    return {f: getattr(sim.dstate, f).clone() for f in STATE_FIELDS}


@pytest.fixture(scope="module")
def runs():
    """One simulation stepped 5 steps, snapshotted, stepped 10 more
    (twice: from the snapshot, and again after restoring it), and a twin
    stepped 15 steps with no snapshot; each run's state, pushed total and
    host step."""
    sim = column_sim()
    sim.run(5)
    snap = sim.snapshot()
    out = {}
    for name in ("after_snapshot", "after_restore"):
        reset_obstacle_pushed()
        sim.run(10)
        out[name] = (state_of(sim), int(obstacle_pushed("cpu")), sim._step)
        sim.restore(snap)
    twin = column_sim()
    twin.run(5)
    reset_obstacle_pushed()
    twin.run(10)
    out["uninterrupted"] = (state_of(twin), int(obstacle_pushed("cpu")),
                            twin._step)
    out["snap"] = snap
    return out


@pytest.mark.parametrize("other", ["after_restore", "uninterrupted"])
def test_restore_gives_the_same_steps_bitwise(runs, other):
    a, pa, sa = runs["after_snapshot"]
    b, pb, sb = runs[other]
    assert sa == sb == 15 and pa == pb > 0
    for f in STATE_FIELDS:
        assert torch.equal(a[f], b[f]), f
    assert int(a["step_count"]) == 15


def test_snapshot_holds_clones_of_every_state_tensor(runs):
    snap = runs["snap"]
    assert set(snap["state"]) == set(STATE_FIELDS)
    assert snap["step"] == 5 and snap["substeps"] == 5
    assert int(snap["state"]["step_count"]) == 5


def test_snapshot_refuses_a_mesh_and_another_substep_count():
    sim = column_sim()
    snap = sim.snapshot()
    other = FluidSimulation(*dam_break_3d(2000, dense_k=8, cell_factor=1.3,
                                          use_pallas=False),
                            substeps=3, device="cpu")
    with pytest.raises(ValueError, match="substeps"):
        other.restore(snap)
    sim.mesh = object()
    with pytest.raises(NotImplementedError):
        sim.snapshot()
    with pytest.raises(NotImplementedError):
        sim.restore(snap)


def test_pushed_is_a_running_total_that_reset_zeroes():
    sim = column_sim()
    reset_obstacle_pushed()
    assert int(sim.counters()["pushed"]) == 0
    sim.run(5)
    first = int(sim.counters()["pushed"])
    sim.run(5)
    assert int(sim.counters()["pushed"]) > first > 0
    assert sim.counters()["pushed"] is obstacle_pushed("cpu")
    reset_obstacle_pushed()
    assert int(sim.counters()["pushed"]) == 0


# -- the plain count against the reference's push -----------------------------

H = 0.05


def planted(ndim: int, obstacles) -> tuple:
    """Particles around a cylinder_z of radius 0.2 at (0.5, 0.5), at
    distances from its axis inside it, on its surface, just inside and
    just outside its band of h/2, and far off, at 12 angles; (params,
    positions [N, 3])."""
    radii = (0.1, 0.2, 0.2 + 0.5 * H - 1e-4, 0.2 + 0.5 * H + 1e-4, 0.35)
    pts = []
    for k in range(12):
        a = 2 * math.pi * (k + 0.25) / 12
        for j, r in enumerate(radii):
            z = 0.0 if ndim == 2 else 0.1 + 0.06 * j
            pts.append((0.5 + r * math.cos(a), 0.5 + r * math.sin(a), z))
    p = SPHParams(ndim=ndim, h=H, particle_mass=0.1, dt=1e-4,
                  bounds_max=(1.0, 1.0, 1.0 if ndim == 3 else 0.0),
                  obstacles=obstacles, dense_k=8, cell_factor=1.3,
                  use_pallas=False)
    return p, torch.tensor(pts, dtype=torch.float32)


def plain_count(p, pos, empty=()):
    spec = dense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)
    d = dense.pack(SPHState.from_positions(pos, p), p, spec, device="cpu")
    if empty:
        # Empty the slots of the particles at these positions (they keep
        # their coordinates): the count reads occupied lanes only.
        occ = d.occ.clone()
        for x in pos[list(empty)]:
            occ[(d.px == x[0]) & (d.py == x[1]) & (d.pz == x[2])] = 0.0
        d = d.replace_fields(occ=occ)
    zero = torch.zeros_like(d.px)
    out = dense._integrate(d, zero, zero, zero, p, 100.0)
    assert out[7].dtype == torch.int32 and out[7].dim() == 0
    return int(out[7])


def reference_count(p, pos) -> int:
    ph = {"obstacles": p.obstacles, "h": p.h,
          "obstacle_stiffness": p.obstacle_stiffness}
    return int((reference._obstacle_accel(pos, ph) != 0).any(-1).sum())


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("obstacles", [
    (("cylinder_z", (0.5, 0.5), 0.2),),
    # Two overlapping pillars: a lane in both bands counts once.
    (("cylinder_z", (0.5, 0.5), 0.2), ("cylinder_z", (0.56, 0.5), 0.2)),
], ids=["one", "overlapping"])
def test_plain_push_count_equals_the_references_push(ndim, obstacles):
    p, pos = planted(ndim, obstacles)
    n = plain_count(p, pos)
    assert n == reference_count(p, pos)
    if len(obstacles) == 1:
        assert n == 12 * 3          # inside, on the surface, inside the band


def test_push_count_reads_no_obstacle_and_no_empty_slot():
    p, pos = planted(3, (("cylinder_z", (0.5, 0.5), 0.2),))
    assert plain_count(p.replace(obstacles=()), pos) == 0
    # Two band particles emptied: two fewer lanes.
    assert plain_count(p, pos, empty=(0, 1)) == 12 * 3 - 2
