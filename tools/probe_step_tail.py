"""The dense step's per-slot tail on one CUDA card, for one checkout of the
port, so that two trees (a parent unpacked under the ignored `build/`, and
this one) can be run in turns in one call and compared on one card.

    python3 tools/probe_step_tail.py [--root DIR] [--out FILE] [--check-only]

`--root` is the checkout whose `sph_tpu_torch` is imported (default: this
one); the helpers (timers, bounds, the busy share) are this checkout's
chip_smoke.py. For the tree:

- where it has the tail kernels (`ops/integrate.py`: F1 `integrate`, F2
  `density_tail`): their ptxas lines, and each held bitwise to its plain
  version at config[3] after 30 steps (K2's accelerations; stirred so the
  clamp and walls fire, with the drag, with a NaN lane; with a sphere, a
  box and the cylinder) and at a 2D scene (K = 4). Also how torch's own
  CUDA kernels evaluate what the kernels follow: `vector_norm` over 2 and
  3 components against the sums written out, and a tensor divided by a
  Python float against its products with two f32 reciprocals.
- unless `--check-only`: config[3] steps/s (host clock, 120 steps after
  30), the step's phases (CUDA events: K1, the density tail, K2, the
  integrator, a rebin), F1 and F2 against their plain versions with their
  bounds, the busy share under torch.profiler, `step_breakdown`, and the
  bench's rungs config[1], [2], [3] and [4] on one device (the bench's
  own functions and settings, without the 8-way dryrun).

Prints the card's `nvidia-smi` name and power limit and one JSON line per
result; with --out, all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def helpers():
    """This checkout's chip_smoke.py, whatever tree is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def torch_semantics(dev) -> dict:
    """How this torch evaluates the ops F1 and F2 follow, on 2^22 random
    values: bitwise or not."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((1 << 22, 3), generator=g, device=dev) - 0.5) * 3.0
    n2 = torch.linalg.vector_norm(x[:, :2], dim=-1)
    n3 = torch.linalg.vector_norm(x, dim=-1)
    sq = x * x
    out = {
        "norm2 = sqrt(x2 + y2)":
            torch.equal(n2, torch.sqrt(sq[:, 0] + sq[:, 1])),
        "norm3 = sqrt((x2 + z2) + y2)":
            torch.equal(n3, torch.sqrt((sq[:, 0] + sq[:, 2]) + sq[:, 1])),
        "norm3 = sqrt((x2 + y2) + z2)":
            torch.equal(n3, torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])),
    }
    # A divisor whose f32 reciprocal 1/f32(m) differs from f32(1/m).
    m = 0.00048
    v = x[:, 0].abs() * 5000.0
    for form, inv in (("f32(1/m)", np.float32(1.0 / m)),
                      ("1/f32(m)", np.float32(1.0) / np.float32(m))):
        t = torch.tensor(float(inv), device=dev)
        out[f"t / m = t * {form}"] = torch.equal(v / m, v * t)
        out[f"0-dim / m = * {form}"] = all(
            torch.equal(v[i] / m, v[i] * t) for i in range(16))
    out["t / m = t / tensor(m)"] = torch.equal(
        v / m, v / torch.tensor(m, device=dev))
    return out


def check_tail(cs, sim, s2, rows: list, dev) -> None:
    """F1 and F2 against their plain versions (chip_smoke.py's tail
    checks), and torch's semantics."""
    emit(rows, {"what": "torch semantics", **torch_semantics(dev)})
    for name, r in cs.tail_checks(sim, s2).items():
        emit(rows, {"what": f"bitwise {name}", **r})


def phases(cs, sim, rows: list, card: str) -> None:
    """CUDA-event ms of each part of a config[3] step, F1/F2 against their
    plain versions, the busy share and the step by host clock."""
    from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
    from sph_tpu_torch.ops.rebin import staged_rebin
    from sph_tpu_torch.sph import dense

    try:
        from sph_tpu_torch.ops import integrate as oi
    except ImportError:      # a tree without the tail kernels
        oi = None
    d, p, spec = sim.dstate, sim.params, sim.spec
    vmax = dense.rebin_vmax(p, spec)
    raw = density_sweep(d.px, d.py, d.pz, d.occ, p, spec)
    rho = dense.density_fixup(raw, d.occ, p)
    from sph_tpu_torch.sph.model import eos_pressure

    prs = torch.where(d.occ > 0.5, eos_pressure(rho, p), 0.0)
    d = d.replace_fields(rho=rho, prs=prs)
    pr2 = prs / (rho * rho)
    acc = accel_sweep(d, pr2, p, spec)
    moved = dense._integrate(d, *acc, p, vmax)[:6]

    def plain_tail():
        r = dense.density_fixup(raw, d.occ, p)
        q = torch.where(d.occ > 0.5, eos_pressure(r, p), 0.0)
        return q / (r * r)

    parts = {
        "K1": lambda: density_sweep(d.px, d.py, d.pz, d.occ, p, spec),
        "tail plain (fixup + EOS + p/rho^2)": plain_tail,
        "K2": lambda: accel_sweep(d, pr2, p, spec),
        "_integrate plain": lambda: dense._integrate(d, *acc, p, vmax),
        "one rebin (K3)": lambda: staged_rebin(d, *moved, p, spec),
    }
    if oi is not None:
        parts["F2 density_tail"] = lambda: oi.density_tail(raw, d.occ, p)
        parts["F1 integrate"] = lambda: oi.integrate(d, *acc, p, vmax)
    plane = d.px.numel() * 4
    bounds = {"F2 density_tail": cs.bound(5 * plane, 0),
              "F1 integrate": cs.bound(16 * plane, 0)}
    for name, fn in parts.items():
        runs = [cs.cuda_ms(fn, 20 if "plain" not in name else 10)
                for _ in range(2)]
        emit(rows, {"what": f"phase {name}", "ms": sum(runs) / 2,
                    "runs_ms": runs, **bounds.get(name, {}), "card": card})
    sps = sim.run(120)
    emit(rows, {"what": "config[3] steps/s (host clock, 120 steps)",
                "sps": sps, "ms_a_step": 1e3 / sps, "card": card})
    emit(rows, {"what": "config[3] busy share (6 steps)",
                "busy": cs.device_busy(lambda: sim.run(p.rebin_every),
                                       card)})


def bench_rungs(rows: list, card: str) -> None:
    """The bench's rungs on one device, and its breakdown at 1M."""
    from sph_tpu_torch import bench
    from sph_tpu_torch.sph.scenes import LAYOUTS
    from sph_tpu_torch.utils.profiling import step_breakdown

    rungs = {
        "config[1] 2D 32k": lambda: bench._bench_2d_dense(32768),
        "config[2] 3D 256k": lambda: bench._bench_dense(262144),
        "config[3] 1M + obstacle": lambda: bench._bench_dense(
            1_000_000, obstacles=bench.OBSTACLE, **LAYOUTS[3]),
        "config[4] 4M one device": lambda: bench._bench_dense(
            4_000_000, steps=45, substeps=15, **LAYOUTS[4]),
    }
    for name, fn in rungs.items():
        t0 = time.perf_counter()
        r = fn()
        emit(rows, {"what": f"bench {name}", **r,
                    "wall_s": time.perf_counter() - t0, "card": card})
        torch.cuda.empty_cache()
    # The bench's --breakdown at 1M: the freshly packed state.
    from sph_tpu_torch.sph.dense import pack

    st, prm, spc = bench._dense_scene(
        **bench.BREAKDOWN["phase_breakdown_1m"])
    emit(rows, {"what": "bench breakdown 1M", **step_breakdown(
        pack(st, prm, spc, device="cuda"), prm, spc), "card": card})


def run(root: str, out: str | None, check_only: bool, cs) -> list:
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.sph import dense

    card = cs.card_line()
    print(f"card: {card}; tree {root}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    if not inspect.getfile(dense).startswith(root + os.sep):
        raise RuntimeError(f"sph_tpu_torch comes from "
                           f"{inspect.getfile(dense)}, not {root}")
    lib = library()
    lines = lib.log.splitlines()
    ptxas = [follow.strip() for i, line in enumerate(lines)
             if "Compiling entry" in line and ("integrate" in line
                                               or "density_tail" in line)
             for follow in lines[i:i + 4]]
    for line in ptxas:
        print("ptxas:", line, flush=True)
    dev = torch.device("cuda", 0)
    rows: list = []
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **cs.CONFIG3)
    sim.run(30)
    has_tail = os.path.exists(os.path.join(root, "sph_tpu_torch", "ops",
                                           "integrate.py"))
    if has_tail:
        s2 = FluidSimulation.from_scene("dam_break_2d", n_target=4096,
                                        dense_k=4, cell_factor=1.2,
                                        rebin_every=3, substeps=6,
                                        device=dev)
        s2.run(6)
        check_tail(cs, sim, s2, rows, dev)
    if not check_only:
        phases(cs, sim, rows, card)
        del sim
        torch.cuda.empty_cache()
        bench_rungs(rows, card)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "root": root, "ptxas": ptxas,
                       "build_s": lib.seconds, "rows": rows}, f, indent=1)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)     # before chip_smoke.py imports the package
    run(root, args.out, args.check_only, helpers())
    return 0


if __name__ == "__main__":
    sys.exit(main())
