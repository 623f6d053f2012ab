"""integrate_roofline.fluid: the per-slot tail F1's share of its
roofline, in percent: its least time (harness/integrate_kernel.py: 60 B a
particle) ÷ the device time of its kernel in the `sph.fluid.integrate`
spans, per launch. None without that kernel."""

from benchmark.harness.integrate_kernel import roofline


def read(ctx):
    return roofline(ctx)
