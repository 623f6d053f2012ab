"""What the fluid cells' per-layer readers share: device time of the
program's `sph.fluid.*` spans, and each sweep and rebin kernel's least
time.

Least time of a kernel = max(bytes ÷ HBM peak, flops ÷ f32 peak), from
what any implementation of the pass must do, counted per particle and per
pair of particles closer than h (not per slot of the program's layout), so
the same work has the same bound at any slot count or cell size:

- density (K1): read a position, write ρ (16 B a particle); per pair,
  r² (8 flops), h² − r², its cube and one add into each side (13 flops);
- accel (K2): read position, velocity, ρ and p/ρ², write the acceleration
  (44 B a particle); per pair, r² (8), 1/r, r, h − r (3), the pressure
  factor (5), the viscosity factor (4), the three components (12) and the
  sum into both sides (6): 38 flops;
- rebin (K3): read and write position, velocity, ρ, p and occupancy (72 B
  a particle); per particle 3 subtractions and 3 divisions (its bin).

Pairs are the driver's `bonds`: unordered pairs closer than h at the
traced frames.
"""

from __future__ import annotations

from benchmark.harness.phases import read_phases
from benchmark.harness.trace import HBM_BYTES_PER_S

F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside tensor cores

# span: (bytes a particle, flops a pair, flops a particle, kernel names)
KERNELS = {
    "density": ("sph.fluid.density", 16, 13, 0, ("DensitySweep",)),
    "accel": ("sph.fluid.accel", 44, 38, 0, ("AccelSweep",)),
    "rebin": ("sph.fluid.rebin", 72, 0, 6,
              ("rebin_codes_kernel", "rebin_place_kernel")),
}


def span_ms_per_step(ctx, span: str):
    """Device ms of the operations launched inside `span` (children
    included) per traced step; None without the program's spans or where
    launches and device operations do not pair."""
    from benchmark.harness.phases import device_s

    ph = read_phases(ctx.trace)
    s = device_s(ph, span) if ph else None
    return None if s is None else 1e3 * s / ctx.traced_steps


def least_s(kernel: str, particles: int, pairs: int) -> float:
    _, b, fp, fq, _ = KERNELS[kernel]
    return max(b * particles / HBM_BYTES_PER_S,
               (fp * pairs + fq * particles) / F32_FLOPS_PER_S)


def roofline(ctx, kernel: str):
    """The kernel's least time × its launches ÷ its device time in the
    traced steps, in percent; None where the trace has no such kernel
    in its span (a program without the spans or the kernel)."""
    ph = read_phases(ctx.trace)
    if ph is None or not ph.launched(ph.steps):
        return None
    span, _, _, _, names = KERNELS[kernel]
    spans = ph.named(span)
    ops = [op for op in ph.launched(spans)
           if any(n in op[2] for n in names)]
    busy = sum(e - s for s, e, _ in ops)
    if not spans or busy <= 0 or not ctx.bonds:
        return None
    return 100.0 * len(spans) * least_s(kernel, ctx.units,
                                        ctx.bonds) / busy
