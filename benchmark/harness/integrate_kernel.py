"""The least time of the dense step's per-slot tail F1 (`integrate`:
gravity, the obstacles' push, drag, the speed clamp, symplectic Euler and
the walls), counted as harness/fluid_kernels.py counts the sweeps: from
what any implementation must move, per particle and not per slot of the
program's layout, so any slot count or cell size reads the same bound.

Per particle F1 reads position, velocity and acceleration (36 B) and
writes position and velocity (24 B): 60 B. Its operations (gravity, the
push's distance and square root, the clamp's norm and division, the
update and the walls: a few dozen a particle) fall far below the f32 rate
at that traffic, so bytes bound it.
"""

from __future__ import annotations

from benchmark.harness.phases import read_phases
from benchmark.harness.trace import HBM_BYTES_PER_S

SPAN = "sph.fluid.integrate"
KERNEL = "integrate_kernel"
BYTES_PER_PARTICLE = 60


def least_s(particles: int) -> float:
    return BYTES_PER_PARTICLE * particles / HBM_BYTES_PER_S


def roofline(ctx):
    """F1's least time × its launches ÷ the device time of its kernel in
    the traced steps' `sph.fluid.integrate` spans, in percent; None where
    the trace has no such kernel in that span (a program without the span
    or the kernel), or where launches and operations do not pair."""
    ph = read_phases(ctx.trace)
    if ph is None or not ph.launched(ph.steps):
        return None
    spans = ph.named(SPAN)
    ops = [op for op in ph.launched(spans) if KERNEL in op[2]]
    busy = sum(e - s for s, e, _ in ops)
    if not spans or busy <= 0:
        return None
    return 100.0 * len(ops) * least_s(ctx.units) / busy
