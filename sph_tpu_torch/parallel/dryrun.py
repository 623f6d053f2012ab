"""The sharded dryrun: the counterpart of the repository's
`__graft_entry__.dryrun_multichip`.

    from sph_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8)                    # 8 ranks on the card(s), gloo
    dryrun_multichip(4, device="cpu", budget_s=0)

A world of `n` torch.distributed ranks (parallel.launch.spawn, gloo)
builds a 1D plane-slab ring and, for an even n ≥ 4, a (2, n // 2) mesh,
and runs the JAX dryrun's checks on them, each held BITWISE to the same
work on one device (which every rank also runs, on its own device):

- the fluid, one sharded step of 300 random particles on the ring and on
  the 2D mesh (k 4, cell factor 1.3, a rebin every step): the nine fields
  of every slot, `dropped` and the step count;
- the contact sweep of a 512-cell bonded colony on both meshes: forces
  and torques, with no overflow;
- the biology step, 4 steps of a 256-cell colony through
  Simulation(mesh=…, scan_chunk=4) on the ring: positions, rotations;
- the division window, only while the run is inside `budget_s` seconds
  (rank 0 decides for every rank): a 128-cell colony resized to 192 with
  16 split timers armed to fire inside the 4 steps: the population,
  positions, uids and the bond table's active flags;
- with `full`, one sharded step of a large random fluid (1,000,000
  particles on a host with ≥ 4 cores, 131,072 otherwise; k 8): nothing
  dropped, every particle in an occupied slot, positions finite.

Rank 0 prints a flushed progress line (stderr) before and after every
check; a rank whose check fails raises, and `spawn` fails the run.
Arguments take the place of JAX's SPH_TPU_DRYRUN_BUDGET_S and
SPH_TPU_DRYRUN_FULL. Ranks that share a card (more ranks than cards)
make a correctness dryrun, not a multi-GPU speed.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from sph_tpu_torch.parallel import dist as pd
from sph_tpu_torch.parallel.launch import spawn
from sph_tpu_torch.sph import dense

# Particles of the large-scale fluid: on a host with at least 4 cores, and
# on a smaller one (the JAX dryrun's sizes).
LARGE_N = (1_000_000, 131_072)
# Seconds the world may take (the JAX bench's limit on its dryrun).
TIMEOUT_S = 1800.0


def _log(t0: float, msg: str) -> None:
    print(f"[dryrun +{time.monotonic() - t0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def dryrun_multichip(n: int, device="cuda", budget_s: float = 240.0,
                     full: bool = False) -> None:
    """Run the dryrun on a world of `n` ranks on `device` ("cuda": rank r
    on card r mod count; "cpu"). Raises if any check fails or the world
    outlives TIMEOUT_S."""
    t0 = time.monotonic()
    kind = torch.device(device).type
    n_large = LARGE_N[0] if (os.cpu_count() or 1) >= 4 else LARGE_N[1]
    _log(t0, f"start: n_ranks={n}, device={kind}, budget={budget_s:.0f}s, "
         f"full={full}")
    job = dict(n=n, device=kind, t0=t0, budget_s=budget_s, full=full,
               n_large=n_large)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_rank, n, "gloo", kind, os.path.join(tmp, "init"),
              args=(job,), timeout=TIMEOUT_S)
    _log(t0, "dryrun_multichip: ALL CHECKS PASSED")


# -- what every rank runs -----------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bitwise(where: str, ref: dict, got: dict) -> None:
    for name, a in ref.items():
        if not torch.equal(_bits(a), _bits(got[name])):
            diff = int((_bits(a) != _bits(got[name])).sum())
            raise AssertionError(f"{where}: {name} differs from one device "
                                 f"in {diff} elements")


def _random_fluid(n: int, seed: int, k: int, device):
    """The JAX dryrun's random fluid in the unit box, on the kernel route
    (plain versions on the CPU): (params, spec, packed state on
    `device`)."""
    from sph_tpu_torch.sph.model import SPHParams, SPHState

    pos = np.random.default_rng(seed).uniform(
        0.05, 0.95, (n, 3)).astype(np.float32)
    h = float((0.15 * 0.729 / n) ** (1 / 3))
    params = SPHParams(
        ndim=3, h=h, particle_mass=1000.0 / n,
        bounds_min=(0.0, 0.0, 0.0), bounds_max=(1.0, 1.0, 1.0),
        dt=0.25 * h / 60.0, sound_speed=60.0,
        dense_k=k, cell_factor=1.3, use_pallas=True, rebin_every=1,
    )
    state = SPHState.from_positions(torch.from_numpy(pos), params)
    spec = dense.make_dense_spec(params, k=k, cell_factor=1.3)
    return params, spec, dense.pack(state, params, spec, device=device)


def _fluid_fields(d) -> dict:
    return {f: getattr(d, f) for f in (*pd.FIELDS, "dropped", "step_count")}


def _colony(n: int, device):
    from sph_tpu_torch.engine.colony import bonded_colony

    return bonded_colony(n, neighbor_mode="dense", dense_k=2,
                         use_pallas=True, device=device)


def _rank(job: dict) -> None:
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.physics.contact_dense import contact_forces_dense

    t0, n = job["t0"], job["n"]
    rank = dist.get_rank()

    def log(msg: str) -> None:
        if rank == 0:
            _log(t0, msg)

    device = (torch.device("cpu") if job["device"] == "cpu"
              else torch.device("cuda", torch.cuda.current_device()))
    dist.barrier()
    log(f"{n} ranks up ({job['device']}, gloo)")
    two_d = n >= 4 and n % 2 == 0
    ring = pd.make_multislice_mesh(device=device)

    # --- the fluid on the ring and on the (2, n // 2) mesh ---
    params, spec, d0 = _random_fluid(300, 0, 4, device)
    log("fluid 1D: running sharded step (n=300, ring halo)")
    out = pd.make_sharded_dense_step(params, spec, ring)(
        pd.shard_dense_state(d0, ring, spec, params), 0)
    out = pd.unshard_dense_state(out, ring, spec)
    log("fluid 1D: running single-device reference")
    ref = _fluid_fields(dense.make_dense_step(params, spec)(d0, 0))
    _bitwise("fluid 1D", ref, _fluid_fields(out))
    log("fluid 1D: PASS (every field and counter bitwise)")
    if two_d:
        log(f"fluid 2D: running (2 x {n // 2}) mesh")
        mesh2 = pd.make_mesh_2d((2, n // 2), device=device)
        out2 = pd.make_sharded_dense_step_2d(params, spec, mesh2)(
            pd.shard_dense_state(d0, mesh2, spec, params), 0)
        out2 = pd.unshard_dense_state(out2, mesh2, spec)
        _bitwise("fluid 2D", ref, _fluid_fields(out2))
        log("fluid 2D: PASS")

    # --- the contact sweep on both meshes ---
    log("contact 1D: building 512-cell bonded colony")
    cstate, cparams, _ = _colony(512, device)
    log("contact 1D: running single-device sweep")
    f1, t1, o1 = contact_forces_dense(cstate, cparams)
    log("contact 1D: running sharded sweep")
    f8, t8, o8 = pd.make_sharded_contact_forces(cparams, ring)(cstate)
    if int(o1) != 0 or int(o8) != 0:
        raise AssertionError(f"contact 1D: overflow {int(o1)}, {int(o8)}")
    _bitwise("contact 1D", {"force": f1, "torque": t1},
             {"force": f8, "torque": t8})
    log("contact 1D: PASS (bitwise)")
    if two_d:
        log("contact 2D: running (z x y) mesh sweep")
        mesh2c = pd.make_mesh_2d((2, n // 2), axis_names=("z", "y"),
                                 device=device)
        fc, tc, oc = pd.make_sharded_contact_forces_2d(cparams,
                                                       mesh2c)(cstate)
        if int(oc) != 0:
            raise AssertionError(f"contact 2D: overflow {int(oc)}")
        _bitwise("contact 2D", {"force": f1, "torque": t1},
                 {"force": fc, "torque": tc})
        log("contact 2D: PASS (bitwise)")

    # --- the full biology step, the sweep decomposed over the ring ---
    def colony_run(mesh):
        st, prm, gen = _colony(256, device)
        sim = Simulation(gen, prm, donate=False, scan_chunk=4, mesh=mesh,
                         device=device)
        sim.state = st
        sim.step(4)
        return sim.state

    log("colony: running 4-step single-device biology step (256 cells)")
    r_ref = colony_run(None)
    log("colony: running 4-step sharded biology step")
    r_mesh = colony_run(ring)
    _bitwise("colony", {"pos": r_ref.pos, "rot": r_ref.rot},
             {"pos": r_mesh.pos, "rot": r_mesh.rot})
    log("colony: PASS (pos/rot bitwise) — mandatory core complete")

    # --- divisions during the sharded window, inside the budget ---
    decision = [job["full"] or time.monotonic() - t0 < job["budget_s"]]
    dist.broadcast_object_list(decision, src=0)
    if decision[0]:
        def colony_div_run(mesh):
            st, prm, gen = _colony(128, device)
            sim = Simulation(gen, prm, donate=False, scan_chunk=4,
                             mesh=mesh, device=device)
            sim.state = st
            sim.resize(192)
            timer = sim.state.split_timer.clone()
            timer[:16] = (float(gen.modes[0].split_interval)
                          - 2.5 * prm.dt)
            sim.state = sim.state.replace_fields(split_timer=timer)
            sim.step(4)
            return sim.state

        log("division: running single-device window (128 cells, 16 "
            "armed timers)")
        r3_ref = colony_div_run(None)
        log("division: running sharded window")
        r3_mesh = colony_div_run(ring)
        if int(r3_ref.active_count) <= 128:
            raise AssertionError(f"division: no split "
                                 f"({int(r3_ref.active_count)} cells)")
        _bitwise("division",
                 {"active_count": r3_ref.active_count, "pos": r3_ref.pos,
                  "uid": r3_ref.uid, "bonds": r3_ref.bonds.active},
                 {"active_count": r3_mesh.active_count, "pos": r3_mesh.pos,
                  "uid": r3_mesh.uid, "bonds": r3_mesh.bonds.active})
        log(f"division: PASS ({int(r3_ref.active_count)} cells; "
            "pos/uid/bonds bitwise)")
    else:
        log(f"division: SKIPPED (elapsed {time.monotonic() - t0:.0f}s >= "
            f"budget {job['budget_s']:.0f}s; full=True forces it)")

    # --- the large-scale sharded fluid step: counts and finiteness ---
    if job["full"]:
        n1m = job["n_large"]
        log(f"large-scale: building n={n1m} sharded fluid step (k=8)")
        prm1, spc1, d1 = _random_fluid(n1m, 1, 8, device)
        out1 = pd.make_sharded_dense_step(prm1, spc1, ring)(
            pd.shard_dense_state(d1, ring, spc1, prm1), 0)
        del d1
        occ = out1.occ > 0.5
        counts = ring.all_reduce(torch.stack([
            occ.sum(), (~torch.isfinite(out1.px) & occ).sum()]))
        if int(out1.dropped) != 0 or int(counts[0]) != n1m or int(counts[1]):
            raise AssertionError(
                f"large-scale: dropped {int(out1.dropped)}, occupied "
                f"{int(counts[0])} of {n1m}, {int(counts[1])} non-finite")
        log("large-scale: PASS (dropped=0, occupancy exact, px finite)")
    else:
        log("large-scale: SKIPPED (full=True enables it; the checks above "
            "cover the same sharding machinery)")
