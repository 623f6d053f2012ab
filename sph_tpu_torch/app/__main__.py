"""Command-line app — the counterpart of sph_tpu.app: run fluid scenes or
the cell-biology simulation, dump metrics and rendered frames. Runs on the
CUDA card unless `--device cpu` is given.

    python -m sph_tpu_torch.app fluid --scene dam_break_3d --n 262144 \\
        --steps 600 --render-every 100 --out out/
    python -m sph_tpu_torch.app cells --steps 600 --capacity 64 \\
        --render-every 100
    python -m sph_tpu_torch.app cells --scene-json scene.json --steps 100
    python -m sph_tpu_torch.app view --frames 120 --script events.json
    python -m sph_tpu_torch.app fluid --n 2000 --steps 20 --device cpu

The viewer loop is headless-first (frames to disk); interaction is exposed
through the library API (Simulation.pick / set_drag — the reference's mouse
drag, ParticleSystemController.cs:975-1034).

`view --substeps n` is the n of the one `Simulation.step(n)` each frame
makes, and the sim's `scan_chunk`, as in the JAX package: one run_steps
chunk a frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_fluid(args) -> int:
    from sph_tpu_torch.engine.fluid import FluidSimulation

    kwargs = {"n_target": args.n}
    if args.scene == "dam_break_3d" and args.obstacle:
        kwargs["obstacles"] = (("cylinder_z", (1.2, 0.15), 0.12),)
    sim = FluidSimulation.from_scene(
        args.scene, substeps=args.substeps, device=args.device, **kwargs
    )
    os.makedirs(args.out, exist_ok=True)
    frame = 0
    done = 0
    while done < args.steps:
        chunk = min(args.render_every or args.steps, args.steps - done)
        sim.run(chunk)
        done += chunk
        m = sim.metrics()
        print(json.dumps(m), flush=True)
        if args.render_every:
            path = os.path.join(args.out, f"frame_{frame:05d}.png")
            sim.render_frame(path)
            frame += 1
    if args.checkpoint:
        sim.save(args.checkpoint)
        print(f"checkpoint written: {args.checkpoint}")
    return 0


def cmd_cells(args) -> int:
    from sph_tpu_torch.engine.config import (
        load_scene,
        reference_genome,
        reference_scene_params,
    )
    from sph_tpu_torch.engine.simulation import Simulation

    if args.scene_json:
        params, genome = load_scene(args.scene_json)
    else:
        genome = reference_genome()
        params = reference_scene_params(capacity=args.capacity).replace(
            dt=args.dt, max_splits_per_step=16,
        )
    sim = Simulation(genome, params, auto_grow=args.auto_grow,
                     device=args.device)
    watcher = None
    if args.watch:
        from sph_tpu_torch.engine.config import watch_scene

        watcher = watch_scene(sim, args.watch)
    os.makedirs(args.out, exist_ok=True)
    frame = 0
    done = 0
    while done < args.steps:
        if watcher is not None and watcher.poll():
            print(json.dumps({"event": "genome_reloaded",
                              "path": args.watch}), flush=True)
        chunk = min(args.render_every or args.steps, args.steps - done)
        sim.run(chunk)
        done += chunk
        m = sim.metrics()
        m["ids"] = sim.particle_ids()[:8]
        print(json.dumps(m), flush=True)
        if args.render_every:
            from sph_tpu_torch.render.overlay import render_cells_frame

            render_cells_frame(
                sim, path=os.path.join(args.out, f"cells_{frame:05d}.png"),
                show_labels=args.labels, show_bonds=True,
            )
            frame += 1
    if args.checkpoint:
        sim.save(args.checkpoint)
        print(f"checkpoint written: {args.checkpoint}")
    return 0


def cmd_view(args) -> int:
    from sph_tpu_torch.app.viewer import ViewerLoop, load_script
    from sph_tpu_torch.engine.config import (
        load_scene,
        reference_genome,
        reference_scene_params,
    )
    from sph_tpu_torch.engine.simulation import Simulation

    if args.scene_json:
        params, genome = load_scene(args.scene_json)
    else:
        genome = reference_genome()
        params = reference_scene_params(capacity=args.capacity).replace(
            dt=args.dt, max_splits_per_step=16,
        )
    sim = Simulation(genome, params, auto_grow=args.auto_grow,
                     scan_chunk=args.substeps, device=args.device)
    watcher = None
    if args.watch:
        from sph_tpu_torch.engine.config import watch_scene

        watcher = watch_scene(sim, args.watch)
    viewer = ViewerLoop(sim, width=args.width, height=args.height,
                        substeps=args.substeps, show_labels=args.labels)
    script = load_script(args.script) if args.script else None
    stats = viewer.run(
        args.frames, script=script,
        out_dir=args.out if args.render else None, tty=args.tty,
        watcher=watcher,
    )
    if not args.tty:
        print(json.dumps(stats[-1]))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sph_tpu_torch.app")
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on a host "
                             "without a card)")

    f = sub.add_parser("fluid", parents=[common],
                       help="run a WCSPH fluid scene")
    f.add_argument("--scene", default="dam_break_3d",
                   choices=["dam_break_2d", "splash_pour_2d", "dam_break_3d",
                            "dam_break_3d_obstacle"])
    f.add_argument("--n", type=int, default=65536)
    f.add_argument("--steps", type=int, default=300)
    f.add_argument("--substeps", type=int, default=10)
    f.add_argument("--render-every", type=int, default=0)
    f.add_argument("--obstacle", action="store_true")
    f.add_argument("--out", default="out")
    f.add_argument("--checkpoint", default="")
    f.set_defaults(fn=cmd_fluid)

    c = sub.add_parser("cells", parents=[common],
                       help="run the cell-biology simulation")
    c.add_argument("--capacity", type=int, default=64)
    c.add_argument("--steps", type=int, default=600)
    c.add_argument("--dt", type=float, default=1 / 60)
    c.add_argument("--auto-grow", action="store_true")
    c.add_argument("--scene-json", default="")
    c.add_argument("--render-every", type=int, default=0)
    c.add_argument("--labels", action="store_true",
                   help="draw PP.UU.C id labels on frames")
    c.add_argument("--out", default="out")
    c.add_argument("--checkpoint", default="")
    c.add_argument("--watch", default="",
                   help="scene/genome JSON to live-watch: edits re-init "
                        "the population (reference OnValidate loop)")
    c.set_defaults(fn=cmd_cells)

    v = sub.add_parser(
        "view", parents=[common],
        help="interactive viewer loop (drag/camera while running)"
    )
    v.add_argument("--capacity", type=int, default=64)
    v.add_argument("--frames", type=int, default=120)
    v.add_argument("--substeps", type=int, default=4,
                   help="physics steps per displayed frame")
    v.add_argument("--dt", type=float, default=1 / 60)
    v.add_argument("--auto-grow", action="store_true")
    v.add_argument("--scene-json", default="")
    v.add_argument("--width", type=int, default=800)
    v.add_argument("--height", type=int, default=450)
    v.add_argument("--script", default="",
                   help="JSON event script: {frame: [events...]}")
    v.add_argument("--render", action="store_true",
                   help="write frames to --out")
    v.add_argument("--tty", action="store_true",
                   help="draw frames in the terminal (ANSI half-blocks)")
    v.add_argument("--labels", action="store_true")
    v.add_argument("--out", default="out")
    v.add_argument("--watch", default="",
                   help="scene/genome JSON to live-watch (polled per frame)")
    v.set_defaults(fn=cmd_view)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
