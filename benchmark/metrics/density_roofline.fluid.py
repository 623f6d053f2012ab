"""density_roofline.fluid: the density sweep K1's share of its roofline,
in percent: its least time (harness/fluid_kernels.py: 16 B a particle,
13 flops a pair closer than h) ÷ the device time of its kernels in the
`sph.fluid.density` spans, per launch. None without that kernel."""

from benchmark.harness.fluid_kernels import roofline


def read(ctx):
    return roofline(ctx, "density")
