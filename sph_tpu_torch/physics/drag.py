"""Interactive drag impulse on the selected particle (ApplyDragForce,
SimulateParticles.compute:311-324) — the counterpart of
sph_tpu.physics.drag."""

from __future__ import annotations

import torch

from sph_tpu_torch.core.types import SimParams, SimState


def apply_drag_force(state: SimState, params: SimParams,
                     dt=None) -> SimState:
    d = state.drag_input
    dt = params.dt if dt is None else dt
    sel = d.selected_slot
    valid = (sel >= 0) & (sel < state.capacity)
    # A one-element index tensor: indexing with a 0-dim tensor would read
    # it back to the host and wait for the device.
    idx = torch.clamp(sel, 0, state.capacity - 1).long().reshape(1)
    to_target = d.target - state.pos[idx]
    impulse = to_target * d.strength * dt / state.mass[idx][:, None]
    vel = state.vel.clone()
    vel.index_put_((idx,), vel[idx] + torch.where(valid, impulse, 0.0))
    return state.replace_fields(vel=vel)
