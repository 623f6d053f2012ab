"""host_reads_per_step.colony: the program's blocking device-to-host reads
(its `sph.read.*` spans) inside the benchmark's step spans, per step of the
traced frames. None on a trace without the program's spans."""

from benchmark.harness.phases import read_phases, reads


def read(ctx):
    ph = read_phases(ctx.trace)
    return None if ph is None else reads(ph) / ctx.traced_steps
