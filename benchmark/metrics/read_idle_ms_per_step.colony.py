"""read_idle_ms_per_step.colony: the device's idle time inside the
benchmark's step spans in gaps that begin while the host is inside one of
the program's `sph.read.*` spans (the queue ran dry on a blocking read),
per step of the traced frames. None on a trace without the program's
spans, or with no device work."""

from benchmark.harness.phases import read_idle_s, read_phases


def read(ctx):
    ph = read_phases(ctx.trace)
    s = read_idle_s(ph) if ph else None
    return None if s is None else 1e3 * s / ctx.traced_steps
