"""What each rank of the CPU worlds in tests/test_torch_dist.py runs.

`run` is sent to spawned ranks by module path, so this module imports only
the port (never JAX): a rank imports nothing of the test file. Jobs and
results are numpy arrays and plain values."""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from sph_tpu_torch.core.types import (
    SimParams,
    state_from_numpy,
    state_to_numpy,
)
from sph_tpu_torch.engine.config import genome_from_json
from sph_tpu_torch.parallel import dist as pd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.model import SPHParams
from sph_tpu_torch.utils.convert import state_from_numpy as dense_from_numpy

CPU = torch.device("cpu")


def run(jobs: list) -> dict:
    """Every (name, function name, case) job in order, on every rank of
    the world; returns {name: result}."""
    return {name: globals()[fn](case) for name, fn, case in jobs}


def mesh_of(shape, axis_names=None, ranks=None) -> pd.Mesh:
    """The CPU mesh of `shape` over the whole world."""
    if len(shape) == 1:
        return pd.make_multislice_mesh(ranks, device=CPU)
    return pd.make_mesh_2d(tuple(shape), ranks,
                           axis_names=axis_names or ("x", "y"), device=CPU)


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def dense_numpy(d) -> dict:
    return {f.name: getattr(d, f.name).cpu().numpy()
            for f in dataclasses.fields(d)}


def halos(case: dict) -> dict:
    """This rank's padded blocks of `arr` [n·P, K, C] over a ring of every
    rank: exchange_halo of its planes, and exchange_row_halo of its lanes
    cut in n blocks of whole rows of X."""
    mesh = mesh_of((0,))
    n, r = mesh.size, mesh.rank
    t = torch.from_numpy(case["arr"])
    P, cols = t.shape[0] // n, t.shape[2] // n
    planes = pd.exchange_halo(t[r * P:(r + 1) * P].contiguous(), mesh)
    rows = pd.exchange_row_halo(t[:, :, r * cols:(r + 1) * cols].contiguous(),
                                case["X"], mesh, "x", case["fill"])
    return {"planes": planes.numpy(), "rows": rows.numpy()}


def fluid(case: dict) -> dict:
    """The case's dense state (numpy fields, params dict, spec dict)
    stepped on a mesh of `shape`, one sharded step call of each size in
    `blocks`: rank 0 returns the unsharded state after the first call
    (`early`) and after the last (`state`); every rank a digest of the
    last."""
    mesh = mesh_of(case["shape"])
    params = SPHParams(**case["params"])
    spec = dense.DenseSpec(**case["spec"])
    d = pd.shard_dense_state(dense_from_numpy(case["state"], CPU), mesh,
                             spec, params)
    states, step = [], 0
    for n in case["blocks"]:
        d = pd.make_sharded_step(params, spec, mesh, n)(d, step)
        step += n
        states.append(dense_numpy(pd.unshard_dense_state(d, mesh, spec)))
    first = mesh.rank == 0
    return {"digest": digest(states[-1]),
            "state": states[-1] if first else None,
            "early": states[0] if first else None,
            "block": tuple(d.px.shape), "halo_bytes": mesh.stats["halo_bytes"]}


def contact(case: dict) -> dict:
    """Sharded contact forces of a colony state on a mesh of `shape`."""
    mesh = mesh_of(case["shape"], ("z", "y"))
    params = SimParams(**case["params"])
    state = state_from_numpy(case["state"], CPU)
    make = (pd.make_sharded_contact_forces if mesh.ndim == 1
            else pd.make_sharded_contact_forces_2d)
    f, t, o = make(params, mesh)(state)
    return {"force": f.numpy(), "torque": t.numpy(), "overflow": int(o)}


def colony(case: dict) -> dict:
    """Simulation(mesh=…, scan_chunk=…) from the case's state, params and
    genome for `steps` steps: rank 0 returns the final state, every rank a
    digest and the adhesion plan's branch counts."""
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.physics import adhesion

    mesh = mesh_of(case["shape"], ("z", "y"))
    sim = Simulation(genome_from_json(case["genome"]),
                     SimParams(**case["params"]), device=CPU, mesh=mesh,
                     scan_chunk=case.get("scan_chunk", 64))
    sim.state = state_from_numpy(case["state"], CPU)
    adhesion.reset_plan_counts()
    sim.step(case["steps"])
    out = state_to_numpy(sim.state)
    return {"digest": digest(out), "state": out if mesh.rank == 0 else None,
            "plan_counts": dict(adhesion.PLAN_COUNTS)}


def checkpoints(case: dict) -> dict:
    """FluidSimulation checkpoints across meshes both ways: the case's
    checkpoint loaded on the ring, stepped and saved, loaded on one device;
    that sim saved (rank 0) and loaded on the ring; each stepped alike.
    Rank 0 returns the three final states."""
    from sph_tpu_torch.engine.fluid import FluidSimulation

    mesh = mesh_of((0,))
    ring = FluidSimulation.load(case["path"], device=CPU, mesh=mesh)
    ring.run(case["steps"])
    a = os.path.join(case["dir"], "from_ring.npz")
    ring.save(a)
    one = FluidSimulation.load(a, device=CPU)
    b = os.path.join(case["dir"], "from_one.npz")
    if mesh.rank == 0:
        one.save(b)
    mesh.barrier()
    ring2 = FluidSimulation.load(b, device=CPU, mesh=mesh)
    for sim in (ring, one, ring2):
        sim.run(case["steps"])
    out = {"ring": dense_numpy(ring._global_state()),
           "ring2": dense_numpy(ring2._global_state()),
           "metrics": ring.metrics()}
    if mesh.rank != 0:
        return {"metrics": out["metrics"]}
    out["one"] = dense_numpy(one.dstate)
    out["one_metrics"] = one.metrics()
    return out


def order(case: dict) -> dict:
    """The rank grids of the mesh builders over fabricated (rank, node)
    records (the world's ranks, placed on made-up hosts)."""
    fakes = [pd.RankInfo(r, node) for r, node in case["fakes"]]
    return {"ring": mesh_of((0,), ranks=list(fakes)).ranks.tolist(),
            "grid": mesh_of((2, 4), ("z", "y"), list(fakes)).ranks.tolist()}


def fail_on_rank(rank: int) -> None:
    """Raises on `rank`; every other rank waits in a collective that the
    failed rank never joins."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.zeros(1))


def slabs(case: dict) -> dict:
    """This rank's halo-padded blocks as the sharded fluid step's
    exchanges build them (the pad of every field), for holding
    parallel.dist's mesh-free fluid_slab to them."""
    mesh = mesh_of(case["shape"], ("z", "y"))
    params = SPHParams(**case["params"])
    spec = dense.DenseSpec(**case["spec"])
    d = pd.shard_dense_state(dense_from_numpy(case["state"], CPU), mesh,
                             spec, params)
    slab = pd._Slab(params, spec, mesh, *pd.blocks(spec, mesh.shape))
    fluid = slab.pad({f: getattr(d, f) for f in pd.FIELDS})
    return {"coords": mesh.coords,
            "fluid": {f: t.numpy() for f, t in fluid.items()}}
