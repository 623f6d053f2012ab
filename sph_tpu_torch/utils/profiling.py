"""Tracing / profiling utilities — the counterpart of sph_tpu.utils.profiling
(SURVEY §5.1). The reference has no profiling hooks at all (its only perf
knob is Application.targetFrameRate, ParticleSystemController.cs:213).

- `trace(log_dir)`: a torch.profiler scope that writes a Chrome trace
  (`trace.json`) of whatever runs inside, the card's kernels included when
  there is one.
- `step_breakdown(...)`: per-phase times of the dense fluid step —
  occupancy, density pass, force pass, integrate, rebin, the whole step —
  under the same keys as the JAX package, with achieved rates against the
  card's peaks. Each phase goes through `dense.step_passes` as the step
  does, so on the card K1–K3, F1 and F2 run. Times are CUDA events on the card and the
  host clock on the CPU.

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
    out = {k: round(v, 3) for k, v in out.items()}
    out.update(_roofline(out, dstate, spec))
    return out


def _n_swept(spec) -> int:
    """Partner variants a lane's Newton-halved sweep visits (half the
    stencil; `ops.fluid.partners` counts the full one)."""
    from sph_tpu_torch.sph.dense import sweep_groups

    return sum(len(g[2]) * len(list(g[3])) for g in sweep_groups(spec))


def _roofline(ms: dict, dstate, spec) -> dict:
    """Analytic flop/byte counts per phase (the JAX package's per-lane
    counts) → achieved GFLOP/s, GB/s and % of the card's peaks (the larger
    of the two shares). As in the JAX package every lane of the layout is
    counted, occupied or not; the sweeps and the rebin skip empty rows on
    the card, so their rates here can pass 100% of a peak."""
    N0, K, C = dstate.occ.shape
    lanes = N0 * K * C
    sw = _n_swept(spec)
    nz = 2 if spec.stencil0 else 1
    # (flops/lane, bytes/lane) per phase. Pair passes: 3 inputs × 3 blocks
    # × nz reads + outputs; integrate: ~40 flops over 13 field r/w; rebin:
    # 3 stages × (3 candidate reads + 1 write) of 7 fields; occupancy: one
    # occ read, /64 write.
    est = {
        "grid_build": (1, 4 * (1 + 1 / 64)),
        "density": (16 * sw, 4 * (3 * 3 * nz + 1 + 2 * 1)),
        "force": (40 * sw + 2 * sw * 8, 4 * (3 * 8 * nz + 3 + 2 * 3)),
        "integrate": (40, 4 * 13 * 2),
        "rebin": (3 * 7 * 10, 4 * 3 * 7 * (3 + 1)),
    }
    out = {}
    for phase, (fl, by) in est.items():
        t = ms.get(f"{phase}_ms", 0.0)
        if t <= 0:
            continue
        gflops = lanes * fl / (t * 1e-3) / 1e9
        gbps = lanes * by / (t * 1e-3) / 1e9
        out[f"{phase}_gflops"] = round(gflops, 1)
        out[f"{phase}_gbps"] = round(gbps, 1)
        out[f"{phase}_pct_roof"] = round(
            100.0 * max(gflops * 1e9 / F32_FLOPS,
                        gbps * 1e9 / HBM_BYTES_PER_S), 1)
    return out
