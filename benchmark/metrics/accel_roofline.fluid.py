"""accel_roofline.fluid: the pressure + viscosity sweep K2's share of its
roofline, in percent: its least time (harness/fluid_kernels.py: 44 B a
particle, 38 flops a pair closer than h) ÷ the device time of its kernels
in the `sph.fluid.accel` spans, per launch. None without that kernel."""

from benchmark.harness.fluid_kernels import roofline


def read(ctx):
    return roofline(ctx, "accel")
