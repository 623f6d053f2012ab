"""Design probe of the fluid pair sweeps K1/K2 (csrc/fluid_sweep.cu) on one
CUDA card: the ptxas lines of every sweep and gate kernel, then per scene
the sweeps through their wrappers (ops/fluid.py) checked bitwise against
the plain versions and timed with CUDA events, with the share of the
partner slots their walk screens (`ops.fluid.sweep_screens`).

    python3 tools/probe_band_sweep.py [--root DIR] [--scenes LIST]
        [--rows 1,2] [--reps 20] [--sass] [--out FILE]

Scenes: `config3`, config[3] at its layout stepped 30 steps; `impact`,
the same stepped 7,050 steps, past the pillar (the benchmark's impact cell
traces steps 7,040–7,060); `k8`, the 20,000-particle 3D scene of the card
tests at 8 slots a cell, stepped 12 steps; `ring`, block 0 of config[4]'s
4-ring ([61, 8, 16384], `parallel.dist.fluid_slab`) after 45 steps;
`config1` (2D, 32,768 particles) and `config2` (262,144), the bench's
rungs at their layouts, stepped 30 steps.

Prints the card's name and power limit, each sweep and gate kernel's
registers and spill (K, stencil), and one line per scene: occupied slots,
the screen shares a lane and a warp at a time, ms of two runs of `--reps`
calls of each sweep (gate, sweep and the scratch's zeroing included) and
whether it was bitwise (+0 on empty slots); then each sweep's device time
by kernel under torch.profiler (10 calls). `--rows` times forced band
heights as well; `--sass` prints the SASS opcode counts of each sweep
kernel (cuobjdump). `--root` imports `sph_tpu_torch` from another
checkout (an unpacked parent, for turns in one call); a package without
`sweep_screens` prints no shares. `--out` appends each scene's line as
JSON.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("config3", "impact", "k8", "ring", "config1", "config2")


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


def ptxas(log: str) -> list[str]:
    """One line per fluid_sweep kernel of the build log: its kind, Sweep,
    K and plane stencil, registers, spill stores and stack bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            spill = stack = "0"
            continue
        if not name or not re.search(r"band_(gate|sweep)_kernel", name):
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = m.group(1), m.group(2)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kind = "sweep" if "band_sweep" in name else "gate"
            sweep = "accel" if "AccelSweep" in name else "density"
            ks = re.search(r"ELi(\d+)ELi(\d)E", name)
            walk = re.search(r"ELb([01])E", name)
            shape = (f"K={ks.group(1)} S0={ks.group(2)}" if ks else
                     "extent walk" if walk and walk.group(1) == "1" else
                     "full walk")
            out.append(f"ptxas {sweep} {kind} {shape}: {m.group(1)} regs, "
                       f"{spill} B spilled, {stack} B stack")
            name = None
    return out


def scene_state(name: str, dev):
    """(state, params, spec) of a scene of SCENES."""
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.sph.scenes import LAYOUTS

    if name in ("config3", "impact"):
        sim = FluidSimulation.from_scene(
            "dam_break_3d_obstacle", substeps=10, device=dev,
            n_target=1_000_000, **LAYOUTS[3])
        sim.run(30 if name == "config3" else 7050)
    elif name in ("config1", "config2"):
        n = 1 if name == "config1" else 2
        sim = FluidSimulation.from_scene(
            "splash_pour_2d" if n == 1 else "dam_break_3d", substeps=10,
            device=dev, n_target=32768 if n == 1 else 262144,
            use_pallas=True, **LAYOUTS[n])
        sim.run(30)
    elif name == "k8":
        sim = FluidSimulation.from_scene(
            "dam_break_3d_obstacle", substeps=6, device=dev, n_target=20000,
            cell_factor=1.38, dense_k=8, rebin_every=6)
        sim.run(12)
    else:
        from sph_tpu_torch.parallel.dist import fluid_slab

        sim = FluidSimulation.from_scene(
            "dam_break_3d", substeps=15, device=dev, n_target=4_000_000,
            use_pallas=True, **LAYOUTS[4])
        sim.run(45)
        slab, sspec = fluid_slab(sim.dstate, sim.params, sim.spec, (4,),
                                 (0,))
        return slab, sim.params, sspec
    return sim.dstate, sim.params, sim.spec


def probe_scene(name: str, dev, args, card: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch.ops import fluid as F
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.utils.verify import accel_inputs

    d0, p, spec = scene_state(name, dev)
    d = accel_inputs(d0, p, spec)
    pr2 = d.prs / (d.rho * d.rho)
    occ = d.occ > 0.5
    plain_rho = dense.density_raw(d.px, d.py, d.pz, p, spec)
    plain_acc = dense.accel_raw(d, torch.reciprocal(d.rho), pr2, p, spec)
    row = {"scene": name, "shape": list(d.px.shape),
           "occupied": int(occ.sum()), "card": card}
    if hasattr(F, "sweep_screens"):
        s = F.sweep_screens(d.occ, spec)
        row.update(lane_share=round(s.lane_share, 4),
                   warp_share=round(s.warp_share, 4), warps=s.warps,
                   partners=s.partners)

    def bits(x):
        return x.view(torch.int32)

    def exact(kern, plain):
        return (torch.equal(bits(kern[occ]), bits(plain[occ]))
                and not bool(bits(kern[~occ]).any()))

    def k1():
        return F.density_sweep(d.px, d.py, d.pz, d.occ, p, spec)

    def k2():
        return F.accel_sweep(d, pr2, p, spec)

    chosen = F.band_plan
    plans = [chosen(spec)] + [F._plan(spec, int(r)) for r in
                              args.rows.split(",") if r]
    try:
        for i, q in enumerate(plans):
            if q.smem_bytes > F.SMEM_LIMIT:
                continue
            F.band_plan = lambda _spec, q=q: q
            ok1 = exact(k1(), plain_rho)
            ok2 = all(exact(a, b) for a, b in zip(k2(), plain_acc))
            t1 = [cuda_ms(k1, args.reps) for _ in range(2)]
            t2 = [cuda_ms(k2, args.reps) for _ in range(2)]
            key = "" if i == 0 else f"rows{q.rows}_"
            row.update({f"{key}rows": q.rows, f"{key}smem": q.smem_bytes,
                        f"{key}density_ms": t1, f"{key}accel_ms": t2,
                        f"{key}exact": ok1 and ok2})
    finally:
        F.band_plan = chosen
    for sweep, fn in (("density", k1), ("accel", k2)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if us > 0 and re.search(r"band_(gate|sweep)_kernel", e.key):
                kinds = ["gate"]
                if "band_sweep" in e.key:
                    walk = re.search(r"(true|false)>|Lb([01])E", e.key)
                    kinds = ["sweep"] + ([] if not walk else [
                        "sweep_extent" if walk.group(0) in ("true>", "Lb1E")
                        else "sweep_full"])
                for kind in kinds:
                    key = f"{sweep}_{kind}_device_ms"
                    row[key] = round(row.get(key, 0.0) + us / 10 / 1e3, 5)
    print(f"scene {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--rows", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; package: {os.path.abspath(args.root)}", flush=True)

    from sph_tpu_torch.ops.build import library

    lib = library()
    print(f"build {lib.seconds:.1f} s", flush=True)
    for line in ptxas(lib.log):
        print(line, flush=True)
    dev = torch.device("cuda", 0)
    for name in args.scenes.split(","):
        row = probe_scene(name, dev, args, card)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"root": os.path.abspath(args.root),
                                    **row}) + "\n")
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
