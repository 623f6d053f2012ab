"""Rebin demand of config[3] at a dense layout, on one CUDA card: the
benchmark's seeded column (benchmark/scenes/dam_break_obstacle.py, the
`dam_break_obstacle_1m` configuration) stepped whole episodes through
FluidSimulation at each layout asked for, and at every rebin

- the kernel's demand peak (`ops.rebin_peak`: the most particles that
  sought one cell at any stage of that rebin) and the particles it dropped;
- the final demand of every cell (particles whose integrated position
  bins there, counted with `torch.bincount`), its largest, and where the
  cells sought by more than K particles lie: `pillar` (within 2 cells of
  the cylinder's surface), `floor` (the 2 lowest cell layers), `walls`
  (within 2 cells of another wall), else `front`;

and every 500 steps the front (the largest x of a particle) and the
particles within h/2 of the pillar's surface, where its push acts; then
one uninstrumented run of the same steps at the first seed for the
layout's steps/s.

    python3 tools/probe_fluid_demand.py [--layouts 8:1.38:6,16:1.38:6]
        [--seeds 3000000001,3000000002,3000000003] [--steps 3000]
        [--out chiprun_out/fluid_demand.json] [--device cuda]
        [--n-target N]

A layout is K:cell_factor:rebin_every. Prints one line a layout and seed
and writes every rebin's record to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEV = torch.device("cuda", 0)


def where(cells, spec, params):
    """Counts of overfull cells by place, from layout coordinates."""
    wc = []
    for wa in range(3):
        li = spec.axis_map.index(wa)
        wc.append(cells[:, li].double())
    x, y, z = ((wc[a] + 0.5) * spec.cell + spec.origin[a] for a in range(3))
    lo, hi = params.bounds_min, params.bounds_max
    near = 2 * spec.cell
    (cx, cy), r = params.obstacles[0][1], params.obstacles[0][2]
    pillar = (torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r).abs() < near
    floor = ~pillar & (y - lo[1] < near)
    walls = ~pillar & ~floor & ((x - lo[0] < near) | (hi[0] - x < near)
                                | (z - lo[2] < near) | (hi[2] - z < near)
                                | (hi[1] - y < near))
    front = ~pillar & ~floor & ~walls
    return {k: int(v.sum()) for k, v in (("pillar", pillar), ("floor", floor),
                                         ("walls", walls), ("front", front))}


def run(layout, seed, steps, cfg, records, flow):
    from benchmark.scenes.dam_break_obstacle import build
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops import rebin_peak, reset_rebin_peak
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.sph.model import SPHParams, SPHState

    k, cf, every = layout
    dev = DEV
    sc = build(cfg, seed, dev)
    pos = sc.pop("pos")
    keys = ("ndim", "h", "rest_density", "particle_mass", "sound_speed",
            "gamma", "viscosity", "gravity", "dt", "bounds_min",
            "bounds_max", "boundary_damping", "obstacles",
            "obstacle_stiffness")
    params = SPHParams(**{key: sc[key] for key in keys}, dense_k=k,
                       cell_factor=cf, rebin_every=every, use_pallas=True)
    sim = FluidSimulation(SPHState.from_positions(pos, params), params,
                          substeps=10, device=dev)
    spec = sim.spec
    real = dense.step_passes
    step = [0]

    def passes(p):
        f = real(p)

        def rebin(d, px, py, pz, vx, vy, vz, p_, s_):
            occ = d.occ > 0.5
            cs = [dense.bin_coord(q[occ], spec.origin[wa], spec.cell,
                                  spec.world_cells()[wa])
                  for q, wa in zip((px, py, pz), range(3))]
            lay = [cs[spec.axis_map[i]].long() for i in range(3)]
            cid = (lay[0] * spec.n1 + lay[1]) * spec.n2 + lay[2]
            counts = torch.bincount(cid, minlength=spec.n0 * spec.n1
                                    * spec.n2)
            reset_rebin_peak()
            out = f.rebin(d, px, py, pz, vx, vy, vz, p_, s_)
            over = torch.nonzero(counts > s_.k)[:, 0]
            cells = torch.stack([over // (spec.n1 * spec.n2),
                                 over // spec.n2 % spec.n1,
                                 over % spec.n2], -1)
            peak, dmax, drop = torch.stack([
                rebin_peak(dev).long(), counts.max(),
                (out.dropped - d.dropped).long()]).tolist()
            records.append({"step": step[0], "peak": peak,
                            "final_max": dmax, "dropped": drop,
                            "over": where(cells, spec, params)
                            if len(over) else {}})
            return out

        return f._replace(rebin=rebin)

    dense.step_passes = passes
    (cx, cy), radius = params.obstacles[0][1], params.obstacles[0][2]
    try:
        for i in range(steps // 10):
            step[0] = 10 * i
            sim.run(10)
            if (i + 1) % 50 == 0:
                pos = sim.particles()[0]
                sd = ((pos[:, 0] - cx) ** 2 + (pos[:, 1] - cy) ** 2) ** 0.5
                flow.append((round(float(pos[:, 0].max()), 4),
                             int((sd - radius < params.h * 0.5).sum())))
    finally:
        dense.step_passes = real
    return sim


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layouts", default="8:1.38:6,16:1.38:6")
    ap.add_argument("--seeds", default="3000000001,3000000002,3000000003")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "fluid_demand.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-target", type=int)
    args = ap.parse_args()
    global DEV
    DEV = torch.device(args.device)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "dam_break_obstacle_1m.json")) as f:
        cfg = json.load(f)
    if args.n_target:
        cfg["n_target"] = args.n_target
    if DEV.type == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    out = {}
    for text in args.layouts.split(","):
        k, cf, every = text.split(":")
        layout = (int(k), float(cf), int(every))
        for seed in (int(s) for s in args.seeds.split(",")):
            recs, flow = [], []
            t = time.perf_counter()
            sim = run(layout, seed, args.steps, cfg, recs, flow)
            n = int(sim.dstate.occ.sum())
            drops = [r for r in recs if r["dropped"]]
            over = {}
            for r in recs:
                for place, c in r["over"].items():
                    over[place] = over.get(place, 0) + c
            line = {"layout": text, "seed": seed, "particles_left": n,
                    "dropped": sum(r["dropped"] for r in recs),
                    "first_drop_step": drops[0]["step"] if drops else None,
                    "peak": max(r["peak"] for r in recs),
                    "final_max": max(r["final_max"] for r in recs),
                    "peak_by_500_steps": [
                        max([r["peak"] for r in recs
                             if a <= r["step"] < a + 500] or [0])
                        for a in range(0, args.steps, 500)],
                    "overfull_cell_rebins_by_place": over,
                    "front_x_by_500_steps": [f[0] for f in flow],
                    "in_pillar_layer_by_500_steps": [f[1] for f in flow],
                    "clamped": int(sim.dstate.clamped),
                    "seconds": round(time.perf_counter() - t, 2)}
            print(json.dumps(line), flush=True)
            out[f"{text}/{seed}"] = {"summary": line, "rebins": recs}
            del sim
        # Steps/s of the layout, uninstrumented.
        from benchmark.scenes.dam_break_obstacle import build
        from sph_tpu_torch.engine.fluid import FluidSimulation
        from sph_tpu_torch.sph.model import SPHParams, SPHState

        sc = build(cfg, int(args.seeds.split(",")[0]), DEV)
        pos = sc.pop("pos")
        keys = ("ndim", "h", "rest_density", "particle_mass",
                "sound_speed", "gamma", "viscosity", "gravity", "dt",
                "bounds_min", "bounds_max", "boundary_damping", "obstacles",
                "obstacle_stiffness")
        params = SPHParams(**{key: sc[key] for key in keys},
                           dense_k=layout[0], cell_factor=layout[1],
                           rebin_every=layout[2], use_pallas=True)
        sim = FluidSimulation(SPHState.from_positions(pos, params), params,
                              substeps=10, device=DEV)
        sim.run(60)
        t = time.perf_counter()
        sim.run(args.steps)
        sps = args.steps / (time.perf_counter() - t)
        print(json.dumps({"layout": text, "steps_per_s": round(sps, 2),
                          "memory_peak_bytes":
                          torch.cuda.max_memory_allocated()
                          if DEV.type == "cuda" else None}), flush=True)
        out[f"{text}/steps_per_s"] = sps
        del sim
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
