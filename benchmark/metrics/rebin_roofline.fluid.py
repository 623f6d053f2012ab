"""rebin_roofline.fluid: the rebin K3's share of its roofline, in percent:
its least time (harness/fluid_kernels.py: 72 B a particle) ÷ the device
time of its two kernels in the `sph.fluid.rebin` spans, per rebin. None
without that kernel."""

from benchmark.harness.fluid_kernels import roofline


def read(ctx):
    return roofline(ctx, "rebin")
