"""Design probe of the fluid pair sweeps K1/K2 (csrc/fluid_sweep.cu) on one
CUDA card: config[3] stepped 30 steps, then each band height the kernels
can take, through the wrappers (ops/fluid.py) with the band plan forced,
checked bitwise against the plain versions and timed with CUDA events.

    python3 tools/probe_band_sweep.py [--rows 1,2,3,4] [--sass]

Prints the card's name and power limit, the ptxas lines of the sweep
kernels, and one line per band height: ms of two 20-call runs of each
sweep (gate, sweep and the work list's zeroing included), the
shared-memory bytes and whether the result was bitwise. Then, at the
chosen plan, each sweep's device time by kernel under torch.profiler
(10 calls), and with --sass the SASS opcode counts of each sweep kernel
(cuobjdump).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import CONFIG3  # noqa: E402


def cuda_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,2,3,4,6,8")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops import fluid as F
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.utils.verify import accel_inputs

    lib = library()
    print(f"build {lib.seconds:.1f} s", flush=True)
    lines = lib.log.splitlines()
    for i, line in enumerate(lines):
        if "fluid_sweep" in line and "Compiling" in line:
            for follow in lines[i:i + 4]:
                print("ptxas:", follow.strip())

    dev = torch.device("cuda", 0)
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **CONFIG3)
    sim.run(30)
    d0, p, spec = sim.dstate, sim.params, sim.spec
    d = accel_inputs(d0, p, spec)
    pr2 = d.prs / (d.rho * d.rho)
    irho = torch.reciprocal(d.rho)
    occ = d.occ > 0.5
    plain_rho = dense.density_raw(d.px, d.py, d.pz, p, spec)
    plain_acc = dense.accel_raw(d, irho, pr2, p, spec)
    print(f"config[3] {list(d.px.shape)}, {int(occ.sum())} occupied, "
          f"chosen plan {F.band_plan(spec)}", flush=True)

    def bits(x):
        return x.view(torch.int32)

    def exact(kern, plain):
        return (torch.equal(bits(kern[occ]), bits(plain[occ]))
                and not bool(bits(kern[~occ]).any()))

    chosen = F.band_plan
    plans = [F._plan(spec, int(r)) for r in args.rows.split(",")]
    try:
        for q in plans:
            if q.smem_bytes > F.SMEM_LIMIT:
                continue
            F.band_plan = lambda _spec, q=q: q

            def k1():
                return F.density_sweep(d.px, d.py, d.pz, d.occ, p, spec)

            def k2():
                return F.accel_sweep(d, pr2, p, spec)

            ok1 = exact(k1(), plain_rho)
            ok2 = all(exact(a, b) for a, b in zip(k2(), plain_acc))
            t1 = [cuda_ms(k1, 20) for _ in range(2)]
            t2 = [cuda_ms(k2, 20) for _ in range(2)]
            print(f"rows {q.rows}: smem {q.smem_bytes} B, density "
                  f"{t1[0]:.4f}/{t1[1]:.4f} ms exact {ok1}, accel "
                  f"{t2[0]:.4f}/{t2[1]:.4f} ms exact {ok2} | {card}",
                  flush=True)
    finally:
        F.band_plan = chosen

    from torch.profiler import ProfilerActivity, profile

    for name, fn in (("density", lambda: F.density_sweep(
            d.px, d.py, d.pz, d.occ, p, spec)),
            ("accel", lambda: F.accel_sweep(d, pr2, p, spec))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if us > 0:
                print(f"profile {name}: {e.key[:60]} {us / 10 / 1e3:.4f} "
                      f"ms/call ({e.count} launches)")
    if args.sass:
        sass(lib.path)
    return 0


def sass(path, match: str = "sweep_kernel") -> None:
    """Opcode counts of each kernel whose name holds `match` in the built
    library."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", str(path)], capture_output=True,
                         text=True, check=True).stdout
    name, counts = None, collections.Counter()
    for line in out.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and match in name:
                top = ", ".join(f"{k} {v}" for k, v in counts.most_common(24))
                print(f"sass {name[-70:]}: {sum(counts.values())} "
                      f"instructions: {top}")
            name, counts = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[m.group(1)] += 1


if __name__ == "__main__":
    sys.exit(main())
