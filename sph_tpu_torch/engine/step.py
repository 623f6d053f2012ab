"""The per-step function — the counterpart of sph_tpu.engine.step: the
reference's frame (ParticleSystemController.cs:244-351 and
CellAdhesionManager.LateUpdate) as one `step(state, params, genome)` in the
order of DESIGN.md §3, and `run_steps` as a host loop.

Eager PyTorch has no `lax.cond`: each gate of the JAX step (pending
splits, ready cells, young bonds, dirty bonds) is a host read of its
predicate. The plain adhesion sum also reads its longest segment: five
reads a quiet step. The planned one reads its changed-bond count instead,
and `run_steps` its rebuild count: six (PERF.md). Each read sits in a
`sph.read.<what>` span and each phase of the step in its `sph.` span
(utils.profiling.span), which a running profiler records.
"""

from __future__ import annotations

import functools

from sph_tpu_torch.biology.bonds import filter_bonds, update_bond_zones
from sph_tpu_torch.biology.division import (
    process_pending_splits,
    queue_splits,
)
from sph_tpu_torch.core.types import GenomeDevice, SimParams, SimState
from sph_tpu_torch.physics import adhesion
from sph_tpu_torch.physics.adhesion import (
    BondPlan,
    apply_adhesion,
    build_bond_plan,
    plan_changed_count,
)
from sph_tpu_torch.physics.contact import (
    apply_contact,
    contact_forces_bruteforce,
)
from sph_tpu_torch.physics.drag import apply_drag_force
from sph_tpu_torch.physics.integrate import update_motion, update_rotation
from sph_tpu_torch.utils.profiling import span


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
         dt=None, contact_fn=None,
         bond_plan: BondPlan | None = None) -> SimState:
    """One full frame (DESIGN.md §3). `dt` overrides params.dt for every
    dt-dependent pass (the variable-dt compat mode, cs:246).

    `contact_fn` (optional, `state -> (force, torque, overflow)`) replaces
    the neighbour-sum dispatch: the hook through which a Simulation on a
    mesh runs the contact sweep decomposed over its ranks
    (parallel.dist.make_sharded_contact_forces[_2d]) while division, bonds
    and integration stay replicated; the result is bitwise the same.

    `bond_plan` (optional, physics.adhesion.BondPlan): the adhesion sum
    then takes the planned accumulate. The plan may be STALE: bonds that
    drifted from its snapshot (division's endpoint rewrites, new bonds)
    are found every step and summed through the hybrid's side table
    (adhesion.accumulate_bond_deltas_hybrid), so it is valid on every
    step, division steps included."""
    with span("sph.step"):
        return _step(state, params, genome, dt, contact_fn, bond_plan)


def _step(state, params, genome, dt, contact_fn, bond_plan):
    # 1-2. Division: apply last step's queued splits, then advance timers
    #      and queue new ones (cs:253 runs before all dispatches).
    with span("sph.division"):
        state = process_pending_splits(state, params, genome)
        state = queue_splits(state, params, genome, dt=dt)

    # 3-4. Neighbour structure + contact forces.
    with span("sph.contact"):
        if contact_fn is None:
            force, torque, cell_overflow = contact_forces(state, params)
        else:
            force, torque, cell_overflow = contact_fn(state)
        state = apply_contact(state, params, force, torque, dt=dt)
        state = state.replace_fields(overflow=state.overflow + cell_overflow)

    # 5. Adhesion constraints — reads post-contact velocities.
    with span("sph.adhesion"):
        state = apply_adhesion(state, params, genome, dt=dt, plan=bond_plan)

    with span("sph.motion"):
        # 6. Interactive drag impulse.
        state = apply_drag_force(state, params, dt=dt)
        # 7-8. Motion + rotation integration.
        state = update_motion(state, params, dt=dt)
        state = update_rotation(state, params, dt=dt)

    # 9-10. Bond zone/anchor refresh for young bonds + pruning.
    with span("sph.bonds"):
        state = state.replace_fields(bonds=update_bond_zones(state, params,
                                                             genome))
        state = state.replace_fields(bonds=filter_bonds(state))
    return state.replace_fields(step_count=state.step_count + 1)


def make_step_fn(params: SimParams, donate: bool = True, contact_fn=None):
    """A step closure over fixed params, `(state, genome) -> state`.

    Memoised on params, as the JAX package's jitted closure is, so callers
    with equal params share one function. There is no jit here, so `donate`
    (JAX's buffer donation) has no effect and is taken for the signature's
    sake. A `contact_fn` closure (one per mesh) is not cached: keying on it
    would keep every Simulation's closure and mesh alive."""
    if contact_fn is not None:
        return lambda st, gd: step(st, params, gd, contact_fn=contact_fn)
    return _step_closure(params)


@functools.lru_cache(maxsize=16)
def _step_closure(params: SimParams):
    return lambda st, gd: step(st, params, gd)


def use_bond_plan(params: SimParams, state: SimState) -> bool:
    """Whether run_steps carries a BondPlan: params.adhesion_plan "on" or
    "off", or under "auto" a bond table of 163,840 rows or more — the JAX
    package's threshold, kept so that the same params take the same path
    in both packages (the card's own crossover is in PERF.md)."""
    if params.adhesion_plan == "off":
        return False
    if params.adhesion_plan == "on":
        return True
    return state.bonds.capacity >= 163840


def run_steps(state: SimState, params: SimParams, genome: GenomeDevice,
              n_steps: int, dts=None, contact_fn=None,
              bond_plan: BondPlan | None = None, return_plan: bool = False):
    """n physics steps as a host loop; `dts` optionally gives each step's
    dt (variable-dt compat, cs:246); `contact_fn` as in `step`.

    Where use_bond_plan says so, every step takes the planned adhesion
    accumulate through one BondPlan — `bond_plan`, or one built from the
    first state — rebuilt after a step that leaves more than half the
    hybrid's side table of bonds drifted from its snapshot.
    `return_plan`: return (state, plan) so that a caller stepping in
    chunks (Simulation) carries the plan on; the plan is None where no plan
    is used."""
    plan = None
    if use_bond_plan(params, state):
        plan = (bond_plan if bond_plan is not None
                else build_bond_plan(state.bonds, state.capacity))
    for i in range(n_steps):
        state = step(state, params, genome,
                     dt=None if dts is None else float(dts[i]),
                     contact_fn=contact_fn, bond_plan=plan)
        if plan is None:
            continue
        with span("sph.plan.check"):
            n_changed = plan_changed_count(state.bonds, plan)
            with span("sph.read.plan"):
                stale = int(n_changed) > adhesion._SIDE_CAP // 2
        if stale:
            plan = build_bond_plan(state.bonds, state.capacity)
    return (state, plan) if return_plan else state
