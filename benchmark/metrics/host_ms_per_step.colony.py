"""host_ms_per_step.colony: the main thread's time inside the benchmark's
step spans (the calls of Simulation.run) less its time in calls that
wait for the device, per step of the traced frames."""

from benchmark.harness.trace import host_work


def read(ctx):
    spans = ctx.trace.spans["bench.steps"]
    if not spans:
        return None
    return 1e3 * host_work(ctx.trace, spans) / ctx.traced_steps
