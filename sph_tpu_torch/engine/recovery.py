"""In-run failure detection and recovery (SURVEY §5.3) — the counterpart of
sph_tpu.engine.recovery.

- `fault_flag(state)`: one device scalar — any non-finite pos/vel/rot
  among the active rows, or counted cell overflow — read by the host once
  per chunk.
- `GuardedRun`: steps the sim in chunks and checks the flag after each.
  On a fault it writes a crash checkpoint (the faulted state, loadable
  with Simulation.load), restores the last good snapshot and applies the
  policy: "halt" raises SimulationFault with the state left at the last
  good snapshot; "rollback" re-runs from the snapshot, for transient
  faults. The step is deterministic, so a fault that recurs from the same
  state is permanent: after `max_retries` of them in a row the guard
  halts.

Snapshots are clones of every tensor on the state's device (no host round
trip); crash dumps go through engine/checkpoint.py's npz format.
"""

from __future__ import annotations

import dataclasses

import torch

from sph_tpu_torch.physics.contact import alive_mask


class SimulationFault(RuntimeError):
    """Raised by GuardedRun on a fault. Carries the step count of the last
    GOOD state (the sim is left restored to it) and the crash-dump path
    (the state AT the fault, for post-mortem)."""

    def __init__(self, msg: str, good_step: int, dump_path: str | None):
        super().__init__(msg)
        self.good_step = good_step
        self.dump_path = dump_path


def fault_flag(state) -> torch.Tensor:
    """int32 scalar on the state's device: 1 iff the state is faulted — a
    non-finite pos/vel/rot among the ACTIVE rows, or counted overflow."""
    alive = alive_mask(state)[:, None]
    bad = torch.zeros((), dtype=torch.bool, device=state.device)
    for f in (state.pos, state.vel, state.rot):
        bad = bad | torch.any(~torch.isfinite(f) & alive)
    return (bad | (state.overflow > 0)).to(torch.int32)


def _device_copy(state):
    """A snapshot of the state: every tensor cloned on its device, nested
    tables included."""
    upd = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = v.clone()
        elif dataclasses.is_dataclass(v):
            upd[f.name] = _device_copy(v)
    return dataclasses.replace(state, **upd)


class GuardedRun:
    """Failure-monitored stepping for a Simulation.

    >>> guard = GuardedRun(sim, chunk=64, policy="halt",
    ...                    dump_path="crash.npz")
    >>> guard.run(10_000)   # raises SimulationFault on NaN/overflow

    policy="rollback" restores the last good snapshot and retries the
    chunk; `max_retries` identical faults in a row halt. The injector hook
    (`inject`) is called as inject(sim, step_count) before each chunk —
    tests use it to corrupt the state mid-run."""

    def __init__(self, sim, chunk: int = 64, policy: str = "halt",
                 dump_path: str | None = "crash_dump.npz",
                 max_retries: int = 2, inject=None):
        if policy not in ("halt", "rollback"):
            raise ValueError(f"unknown policy {policy!r}")
        self.sim = sim
        self.chunk = int(chunk)
        self.policy = policy
        self.dump_path = dump_path
        self.max_retries = int(max_retries)
        self.inject = inject
        self.faults: list[dict] = []

    def run(self, n_steps: int) -> None:
        sim = self.sim
        good = _device_copy(sim.state)
        good_step = int(sim.state.step_count)
        done = 0
        retries = 0
        while done < n_steps:
            n = min(self.chunk, n_steps - done)
            if self.inject is not None:
                self.inject(sim, int(sim.state.step_count))
            sim.step(n)
            if not bool(fault_flag(sim.state)):
                done += n
                retries = 0
                good = _device_copy(sim.state)
                good_step = int(sim.state.step_count)
                continue

            # Fault: dump the faulted state, restore the last good one.
            at = int(sim.state.step_count)
            dump = None
            if self.dump_path:
                try:
                    sim.save(self.dump_path)   # state IS the faulted state
                    dump = self.dump_path
                except OSError:
                    dump = None
            self.faults.append({"at_step": at, "good_step": good_step,
                                "dump": dump})
            sim.state = _device_copy(good)
            if self.policy == "halt":
                raise SimulationFault(
                    f"fault detected at step {at}; state restored to "
                    f"step {good_step}" + (f", dump: {dump}" if dump
                                           else ""),
                    good_step, dump,
                )
            retries += 1
            if retries > self.max_retries:
                raise SimulationFault(
                    f"fault at step {at} reproduced {retries}x from the "
                    f"same state (deterministic step => permanent); "
                    f"halting at good step {good_step}",
                    good_step, dump,
                )
