"""step_roofline.colony: the least time of a step ÷ the device's busy time
a step inside the benchmark's step spans (each ends in a synchronise), in
percent.

Least time: the bytes any implementation of a step must move at the HBM
peak: read and write each cell's position, velocity and spin (3 f32 each)
and orientation (4 f32), 104 B a cell, and read each active bond's two
endpoints (i32) and two body-frame anchors (3 f32 each), 32 B a bond."""

from benchmark.harness.trace import HBM_BYTES_PER_S, device_busy

BYTES_PER_CELL = 2 * (3 + 3 + 3 + 4) * 4
BYTES_PER_BOND = 32


def read(ctx):
    spans = ctx.trace.spans["bench.steps"]
    busy = device_busy(ctx.trace, spans)
    if not spans or busy <= 0:
        return None
    least = (BYTES_PER_CELL * ctx.units
             + BYTES_PER_BOND * ctx.bonds) / HBM_BYTES_PER_S
    return 100.0 * least / (busy / ctx.traced_steps)
