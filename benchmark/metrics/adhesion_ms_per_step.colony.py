"""adhesion_ms_per_step.colony: device time of the operations launched
inside the program's `sph.adhesion` spans (the bond gather, pair math and
per-cell sum), per step of the traced frames. None on a trace without the
program's spans, or where launches and device operations do not pair."""

from benchmark.harness.phases import device_s, read_phases


def read(ctx):
    ph = read_phases(ctx.trace)
    s = device_s(ph, "sph.adhesion") if ph else None
    return None if s is None else 1e3 * s / ctx.traced_steps
