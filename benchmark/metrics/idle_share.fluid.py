"""idle_share.fluid: 1 − the union of the device's activity intervals ÷
the traced window (first frame's start to last frame's end), in percent."""

from benchmark.harness.trace import device_busy


def read(ctx):
    win = ctx.trace.window()
    if win is None or win[1] <= win[0]:
        return None
    return 100.0 * (1.0 - device_busy(ctx.trace, [win]) / (win[1] - win[0]))
