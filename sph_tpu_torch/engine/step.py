"""The per-step function — the counterpart of sph_tpu.engine.step: the
reference's frame (ParticleSystemController.cs:244-351 and
CellAdhesionManager.LateUpdate) as one `step(state, params, genome)` in the
order of DESIGN.md §3, and `run_steps` as a host loop.

Eager PyTorch has no `lax.cond`: each gate of the JAX step (pending
splits, ready cells, young bonds, dirty bonds) is a host read of its
predicate, and the adhesion sum reads its longest segment — five reads a
quiet step (PERF.md). The JAX package's bond plan (its scatter-free TPU
accumulate) is not ported.
"""

from __future__ import annotations

from sph_tpu_torch.biology.bonds import filter_bonds, update_bond_zones
from sph_tpu_torch.biology.division import (
    process_pending_splits,
    queue_splits,
)
from sph_tpu_torch.core.types import GenomeDevice, SimParams, SimState
from sph_tpu_torch.physics.adhesion import apply_adhesion
from sph_tpu_torch.physics.contact import (
    apply_contact,
    contact_forces_bruteforce,
)
from sph_tpu_torch.physics.drag import apply_drag_force
from sph_tpu_torch.physics.integrate import update_motion, update_rotation


def contact_forces(state: SimState, params: SimParams):
    """Neighbour-sum dispatch: brute force (the executable spec), the
    sort+gather grid or the dense sweep. Returns (force, torque,
    overflow)."""
    if params.neighbor_mode == "bruteforce":
        f, t = contact_forces_bruteforce(state, params)
        return f, t, 0
    if params.neighbor_mode == "grid":
        from sph_tpu_torch.ops.grid import contact_forces_grid

        return contact_forces_grid(state, params)
    if params.neighbor_mode == "dense":
        from sph_tpu_torch.physics.contact_dense import contact_forces_dense

        return contact_forces_dense(state, params)
    raise ValueError(f"unknown neighbor_mode {params.neighbor_mode!r}")


def step(state: SimState, params: SimParams, genome: GenomeDevice,
         dt=None, contact_fn=None) -> SimState:
    """One full frame (DESIGN.md §3). `dt` overrides params.dt for every
    dt-dependent pass (the variable-dt compat mode, cs:246).

    `contact_fn` (optional, `state -> (force, torque, overflow)`) replaces
    the neighbour-sum dispatch: the hook through which a Simulation on a
    mesh runs the contact sweep decomposed over its ranks
    (parallel.dist.make_sharded_contact_forces[_2d]) while division, bonds
    and integration stay replicated; the result is bitwise the same."""
    # 1-2. Division: apply last step's queued splits, then advance timers
    #      and queue new ones (cs:253 runs before all dispatches).
    state = process_pending_splits(state, params, genome)
    state = queue_splits(state, params, genome, dt=dt)

    # 3-4. Neighbour structure + contact forces.
    if contact_fn is None:
        force, torque, cell_overflow = contact_forces(state, params)
    else:
        force, torque, cell_overflow = contact_fn(state)
    state = apply_contact(state, params, force, torque, dt=dt)
    state = state.replace_fields(overflow=state.overflow + cell_overflow)

    # 5. Adhesion constraints — reads post-contact velocities.
    state = apply_adhesion(state, params, genome, dt=dt)

    # 6. Interactive drag impulse.
    state = apply_drag_force(state, params, dt=dt)

    # 7-8. Motion + rotation integration.
    state = update_motion(state, params, dt=dt)
    state = update_rotation(state, params, dt=dt)

    # 9-10. Bond zone/anchor refresh for young bonds + pruning.
    state = state.replace_fields(bonds=update_bond_zones(state, params,
                                                         genome))
    state = state.replace_fields(bonds=filter_bonds(state))
    return state.replace_fields(step_count=state.step_count + 1)


def run_steps(state: SimState, params: SimParams, genome: GenomeDevice,
              n_steps: int, dts=None, contact_fn=None) -> SimState:
    """n physics steps as a host loop; `dts` optionally gives each step's
    dt (variable-dt compat, cs:246); `contact_fn` as in `step`."""
    for i in range(n_steps):
        state = step(state, params, genome,
                     dt=None if dts is None else float(dts[i]),
                     contact_fn=contact_fn)
    return state
