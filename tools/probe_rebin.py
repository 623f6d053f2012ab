"""Design probe of the rebin kernel K3 (csrc/rebin.cu) on one CUDA card:
config[3] (chip_smoke.py's CONFIG3) stepped 30 steps through
FluidSimulation, then one rebin through `ops.rebin.staged_rebin` on the
state's integrated fields (the main path's input) and on the crowding
nudge, each checked against the plain `dense.rebin` (equal values on all 9
fields, −0 == +0, equal `dropped`), timed with CUDA events and split by
launch under torch.profiler.

    python3 tools/probe_rebin.py [--root DIR] [--reps 20]

--root imports `sph_tpu_torch` from another checkout (an unpacked parent
commit, say), which builds its own kernels under DIR/build/: two versions
are then compared in one call, in turns (parent, change, change, parent).
Prints the card's name and power limit, the ptxas lines of the rebin
kernels, one line per input (ms of two runs of --reps calls, the host's
enqueue time per call, the plain version's ms, the check), and each
input's device time by launch.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    import sph_tpu_torch
    from chip_smoke import CONFIG3, cuda_ms
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.ops.rebin import staged_rebin
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.utils.verify import nudge

    print(f"card: {card}; package {os.path.dirname(sph_tpu_torch.__file__)}",
          flush=True)
    lib = library()
    print(f"build {lib.seconds:.1f} s", flush=True)
    lines = lib.log.splitlines()
    for i, line in enumerate(lines):
        if "rebin" in line and "Compiling" in line:
            for follow in lines[i:i + 4]:
                print("ptxas:", follow.strip())

    dev = torch.device("cuda", 0)
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **CONFIG3)
    sim.run(30)
    d, p, spec = sim.dstate, sim.params, sim.spec
    moved = dense._integrate(d, *(torch.zeros_like(d.px) for _ in range(3)),
                             p, dense.rebin_vmax(p, spec))[:3]
    inputs = {"integrated": moved, "nudged": nudge(d, spec, p, seed=0)}

    from torch.profiler import ProfilerActivity, profile

    for name, (px, py, pz) in inputs.items():
        def run(px=px, py=py, pz=pz):
            return staged_rebin(d, px, py, pz, d.vx, d.vy, d.vz, p, spec)

        def plain(px=px, py=py, pz=pz):
            return dense.rebin(d, px, py, pz, d.vx, d.vy, d.vz, p, spec)

        a, b = plain(), run()
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("px", "py", "pz", "vx", "vy", "vz", "rho",
                             "prs", "occ"))
        drop = (int(a.dropped - d.dropped), int(b.dropped - d.dropped))
        t = [cuda_ms(run, args.reps) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        host = (time.perf_counter() - t0) / args.reps * 1e3
        torch.cuda.synchronize()
        print(f"{name}: kernel {t[0]:.4f}/{t[1]:.4f} ms, host enqueue "
              f"{host:.4f} ms, plain {cuda_ms(plain, 3):.4f} ms, equal "
              f"{same}, dropped plain/kernel {drop[0]}/{drop[1]} | {card}",
              flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if us > 0:
                print(f"profile {name}: {e.key[:60]} {us / 10 / 1e3:.4f} "
                      f"ms/call ({e.count} launches)")
        if not same or drop[0] != drop[1]:
            raise AssertionError(f"{name}: kernel differs from plain")
    return 0


if __name__ == "__main__":
    sys.exit(main())
