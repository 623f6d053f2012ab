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

With --window S the rebins are not instrumented; instead, every 10 steps
the front and F1's count of pushed lanes (`ops.obstacle_pushed`) give the
first 10-step block in which the push acts and the first in which the
front reaches the far wall (x ≥ tank − h), and every 100 steps from step
S a record holds the front, the particles in the push band, the largest
speed and its share of the layout's speed limit, the state's `clamped`
and `dropped`, the demand peak since the last record and the pushed
lanes a step since the last record. --fallback CF: where a layout's
demand reaches K − 1, the same cadences are run again at cell_factor CF.

    python3 tools/probe_fluid_demand.py [--layouts 8:1.38:6,16:1.38:6]
        [--seeds 3000000001,3000000002,3000000003] [--steps 3000]
        [--out chiprun_out/fluid_demand.json] [--device cuda]
        [--n-target N] [--window S] [--fallback CF]

A layout is K:cell_factor:rebin_every. Prints one line a layout and seed
and writes every rebin's (or window) record to --out.
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


def seeded_sim(layout, seed, cfg):
    """The benchmark's seeded column at `layout` (K, cell_factor,
    rebin_every) through FluidSimulation, 10 steps a call."""
    from benchmark.scenes.dam_break_obstacle import build
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.sph.model import SPHParams, SPHState

    k, cf, every = layout
    sc = build(cfg, seed, DEV)
    pos = sc.pop("pos")
    keys = ("ndim", "h", "rest_density", "particle_mass", "sound_speed",
            "gamma", "viscosity", "gravity", "dt", "bounds_min",
            "bounds_max", "boundary_damping", "obstacles",
            "obstacle_stiffness")
    params = SPHParams(**{key: sc[key] for key in keys}, dense_k=k,
                       cell_factor=cf, rebin_every=every, use_pallas=True)
    return FluidSimulation(SPHState.from_positions(pos, params), params,
                           substeps=10, device=DEV)


def run(layout, seed, steps, cfg, records, flow):
    from sph_tpu_torch.ops import rebin_peak, reset_rebin_peak
    from sph_tpu_torch.sph import dense

    dev = DEV
    sim = seeded_sim(layout, seed, cfg)
    params = sim.params
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


def run_window(layout, seed, steps, cfg, start, records):
    """Steps the seeded column `steps` steps at `layout`; appends the
    window records (every 100 steps from `start`) to `records` and returns
    (sim, first push block, first far-wall block)."""
    from sph_tpu_torch.ops import (
        obstacle_pushed,
        rebin_peak,
        reset_obstacle_pushed,
        reset_rebin_peak,
    )
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.sph.model import obstacle_push

    sim = seeded_sim(layout, seed, cfg)
    params = sim.params
    vmax = dense.rebin_vmax(params, sim.spec)
    wall = params.bounds_max[0] - params.h
    reset_rebin_peak()
    reset_obstacle_pushed()
    first_push = first_wall = None
    since = 0
    for i in range(steps // 10):
        sim.run(10)
        d = sim.dstate
        occ = d.occ > 0.5
        front, pushed = torch.stack([
            torch.where(occ, d.px, -1.0).amax().double(),
            obstacle_pushed(DEV).double()]).tolist()
        if first_push is None and pushed > 0:
            first_push = 10 * i
        if first_wall is None and front >= wall:
            first_wall = 10 * i
        step = 10 * (i + 1)
        if step >= start and step % 100 == 0:
            p = torch.stack([d.px[occ], d.py[occ], d.pz[occ]], -1)
            v = torch.stack([d.vx[occ], d.vy[occ], d.vz[occ]], -1)
            band = obstacle_push(p, params)[1]
            speed = torch.sqrt((v * v).sum(-1)).amax()
            vals = torch.stack([
                band.sum().double(), speed.double(), d.clamped.double(),
                d.dropped.double(), rebin_peak(DEV).double()]).tolist()
            records.append({
                "step": step, "front": round(front, 4),
                "push": int(vals[0]), "max_speed": round(vals[1], 3),
                "speed_share": round(vals[1] / vmax, 4),
                "clamped": int(vals[2]), "dropped": int(vals[3]),
                "peak": int(vals[4]),
                "pushed_per_step": round((pushed - since) / 100, 2)})
            since = pushed
            reset_rebin_peak()
    return sim, first_push, first_wall, vmax


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layouts", default="8:1.38:6,16:1.38:6")
    ap.add_argument("--seeds", default="3000000001,3000000002,3000000003")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "fluid_demand.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-target", type=int)
    ap.add_argument("--window", type=int)
    ap.add_argument("--fallback", type=float)
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
    layouts = args.layouts.split(",")
    fell_back = False
    while layouts:
        text = layouts.pop(0)
        k, cf, every = text.split(":")
        layout = (int(k), float(cf), int(every))
        for seed in (int(s) for s in args.seeds.split(",")):
            if args.window is not None:
                recs = []
                t = time.perf_counter()
                sim, first_push, first_wall, vmax = run_window(
                    layout, seed, args.steps, cfg, args.window, recs)
                line = {"layout": text, "seed": seed, "vmax": vmax,
                        "first_push_block": first_push,
                        "first_far_wall_block": first_wall,
                        "particles_left": int(sim.dstate.occ.sum()),
                        "dropped": int(sim.dstate.dropped),
                        "clamped": int(sim.dstate.clamped),
                        "window_peak": max([r["peak"] for r in recs]
                                           or [0]),
                        "window_max_speed": max([r["max_speed"]
                                                 for r in recs] or [0]),
                        "seconds": round(time.perf_counter() - t, 2)}
                print(json.dumps(line), flush=True)
                print(json.dumps({"records": [
                    [r["step"], r["front"], r["push"], r["max_speed"],
                     r["clamped"], r["dropped"], r["peak"],
                     r["pushed_per_step"]] for r in recs]}), flush=True)
                out[f"{text}/{seed}"] = {"summary": line, "window": recs}
                if (args.fallback and not fell_back
                        and line["window_peak"] >= layout[0] - 1):
                    fell_back = True
                    layouts += [f"{k}:{args.fallback}:{t_.split(':')[2]}"
                                for t_ in args.layouts.split(",")]
                del sim
                continue
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
        sim = seeded_sim(layout, int(args.seeds.split(",")[0]), cfg)
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
