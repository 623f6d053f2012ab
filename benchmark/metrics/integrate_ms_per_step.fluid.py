"""integrate_ms_per_step.fluid: device time of the operations launched
inside the program's `sph.fluid.integrate` spans (F1: gravity, the
obstacles' push, drag, the speed clamp and the walls), per step of the
traced frames. None on a trace without the program's spans, or where
launches and device operations do not pair."""

from benchmark.harness.fluid_kernels import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "sph.fluid.integrate")
