"""Tracing / profiling utilities — the counterpart of sph_tpu.utils.profiling
(SURVEY §5.1). The reference has no profiling hooks at all (its only perf
knob is Application.targetFrameRate, ParticleSystemController.cs:213).

- `trace(log_dir)`: a torch.profiler scope that writes a Chrome trace
  (`trace.json`) of whatever runs inside, the card's kernels included when
  there is one.
- `span(name)`: a named range of the program (the colony step's phases
  and its blocking host reads, all under `sph.`) that a running profiler
  records on the trace's clock, beside the card's kernels; with no
  profiler recording it is a shared no-op.
- `step_breakdown(...)`: per-phase times of the dense fluid step —
  occupancy, density pass, force pass, integrate, rebin, the whole step —
  under the same `*_ms` keys as the JAX package. Each phase goes through
  `dense.step_passes` as the step does, so on the card K1–K3, F1 and F2
  run. Times are CUDA events on the card and the host clock on the CPU.

The card's peaks are kept here, once, for every bound the port states.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# NVIDIA H100 SXM (data sheet, at its 700 W limit): HBM bytes/s and f32
# FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler records
    (the active steps of a schedule, or `trace`), else one shared no-op
    context: the check costs a fraction of a microsecond, so the spans
    stay in the step."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope; writes `log_dir/trace.json` (Chrome trace:
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _timed(body, x, sub: int, rounds: int) -> float:
    """Best ms per application of `body(state, i)` over `rounds` runs of
    `sub` chained applications (i = 0 … sub−1), after one warm-up run."""
    cuda = x.px.device.type == "cuda"

    def run():
        y = x
        for i in range(sub):
            y = body(y, i)
        return y

    run()
    best = float("inf")
    for _ in range(rounds):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / sub)
    return best


def step_breakdown(dstate, params, spec, n=4, sub=30) -> dict:
    """Per-phase ms for one dense fluid step at the current state (best of
    `n` runs of `sub` chained applications). Phases are timed on their own
    (each as a state → state map), so their sum can differ from the whole
    step's time."""
    from sph_tpu_torch.sph import dense

    vmax = dense.rebin_vmax(params, spec)
    f = dense.step_passes(params)

    def ph_occ(d):
        # The sweeps' gate decision: which rows of a plane hold an
        # occupied slot (the kernels make it inside their gate launch; the
        # JAX package's tile_occupancy).
        rows = (d.occ > 0.5).view(spec.n0, spec.k, spec.n1, spec.X)
        t = rows.any(dim=3).any(dim=1)
        return d.replace_fields(rho=d.rho + 1e-30 * t.sum())

    def ph_density(d):
        # K1, then the fixup, the EOS and p/ρ² (F2) as the step runs them.
        rho, prs, _ = f.tail(f.density(d.px, d.py, d.pz, d.occ, params,
                                       spec), d.occ, params)
        return d.replace_fields(rho=rho, prs=prs)

    # The force phase runs on d2 and the states it chains, whose ρ and p
    # it leaves alone: its p/ρ² operand (F2's third output in the step) is
    # formed once.
    d2 = ph_density(dstate)
    pr2 = d2.prs / (d2.rho * d2.rho)

    def ph_force(d):
        ax, ay, az = f.accel(d, pr2, params, spec)
        return d.replace_fields(vx=d.vx + 1e-30 * ax, vy=d.vy + 1e-30 * ay,
                                vz=d.vz + 1e-30 * az)

    def ph_integrate(d):
        z = torch.zeros_like(d.px)
        px, py, pz, *_ = f.integrate(d, z, z, z, params, vmax)
        return d.replace_fields(px=px, py=py, pz=pz)

    def ph_rebin(d):
        return f.rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz, params, spec)

    def full_step(d, i, first=int(dstate.step_count)):
        # The rebin cadence from a host step count, as make_dense_step.
        return dense.dense_step(
            d, params, spec, rebin_now=dense.is_rebin_step(first + i, params))

    def phase(f):
        return lambda d, _i: f(d)

    out = {}
    out["grid_build_ms"] = _timed(phase(ph_occ), dstate, sub, n)
    out["density_ms"] = _timed(phase(ph_density), dstate, sub, n)
    out["force_ms"] = _timed(phase(ph_force), d2, sub, n)
    out["integrate_ms"] = _timed(phase(ph_integrate), d2, sub, n)
    out["rebin_ms"] = _timed(phase(ph_rebin), d2, sub, n)
    out["rebin_amortized_ms"] = out["rebin_ms"] / max(params.rebin_every, 1)
    out["full_step_ms"] = _timed(full_step, dstate, sub, n)
    out["total_ms"] = out["full_step_ms"]
    return {k: round(v, 3) for k, v in out.items()}
