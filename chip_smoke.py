"""GPU smoke test of the PyTorch + CUDA port (sph_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (nonzero exit):

1. device   — needs CUDA; prints the card's name and power limit.
2. build    — builds the hand-written kernels from `sph_tpu_torch/csrc/`.
3. kernels  — each kernel against its plain PyTorch version on the card,
              at config[3] shapes (a 1,005,312-particle state stepped 30
              steps) and at a small 2D spec: density and accel at rtol 1e-5
              / atol 1e-6·max|x| on occupied slots, the rebin bitwise with
              equal `dropped` > 0 under a crowding nudge.
4. main     — config[3] through FluidSimulation (from_scene → run →
              metrics) for 60 steps = 10 rebins, with the launch counters
              reset just before: count conserved, dropped == 0, positions
              finite and in bounds, every sweep and rebin stage launched
              through the kernels. Then a small 2D scene run through the
              kernels against the same run through the plain versions.
5. times    — each kernel's ms against its plain version's at config[3]
              shapes (CUDA events).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG3 = dict(n_target=1_000_000, cell_factor=1.38, dense_k=8,
               rebin_every=6)
N_CONFIG3 = 1_005_312
MAIN_STEPS = 60
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "density": ("sph_tpu_torch/csrc/fluid_sweep.cu",
                "sph_tpu/ops/pallas/fluid.py:124"),
    "accel": ("sph_tpu_torch/csrc/fluid_sweep.cu",
              "sph_tpu/ops/pallas/fluid.py:124"),
    "rebin_stage": ("sph_tpu_torch/csrc/rebin_stage.cu",
                    "sph_tpu/ops/pallas/rebin.py:39"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` launches, timed with CUDA events after
    one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_state(sim, n_expected: int) -> dict:
    m = sim.metrics()
    pos = sim.particles()[0]
    lo = np.asarray(sim.params.bounds_min, np.float32)
    hi = np.asarray(sim.params.bounds_max, np.float32)
    if m["n_particles"] != n_expected:
        raise AssertionError(f"particle count {m['n_particles']} != "
                             f"{n_expected}")
    if m["dropped"] != 0:
        raise AssertionError(f"dropped {m['dropped']} particles")
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite positions")
    nd = sim.params.ndim
    if not ((pos[:, :nd] >= lo[:nd]).all() and (pos[:, :nd] <= hi[:nd]).all()):
        raise AssertionError("positions outside the tank")
    return m


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
    from sph_tpu_torch.ops.rebin import staged_rebin
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.utils.verify import check_fluid_twins

    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib = library()
    say("build", f"{time.perf_counter() - t0:.1f} s (nvcc {lib.seconds:.1f} s)"
        f" -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **CONFIG3)
    say("kernels", f"config[3] packed: {N_CONFIG3} particles, layout "
        f"{list(sim.dstate.px.shape)} ({time.perf_counter() - t0:.1f} s)")
    sim.run(30)
    checks = check_fluid_twins(sim.dstate, sim.params, sim.spec, seed=0)
    for name, r in checks.items():
        say("kernels", f"config[3] {name}: {json.dumps(r)}")
    s2 = FluidSimulation.from_scene("dam_break_2d", n_target=4096,
                                    dense_k=4, cell_factor=1.2,
                                    rebin_every=3, substeps=6, device=dev)
    s2.run(6)
    for name, r in check_fluid_twins(s2.dstate, s2.params, s2.spec,
                                     seed=1).items():
        say("kernels", f"2D {list(s2.dstate.px.shape)} {name}: "
            f"{json.dumps(r)}")

    # 4. main path: config[3], counters reset just before.
    reset_launches()
    sps = sim.run(MAIN_STEPS)
    launches = dict(LAUNCHES)
    m = check_state(sim, N_CONFIG3)
    rebins = MAIN_STEPS // sim.params.rebin_every
    want = {"density": MAIN_STEPS, "accel": MAIN_STEPS,
            "rebin_stage": 3 * rebins}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    say("main", f"config[3] {MAIN_STEPS} steps ({rebins} rebins): "
        f"{sps:.2f} steps/s, {sps * N_CONFIG3:.4g} particle-steps/s, "
        f"clamped {m['clamped']}, launches {launches}")
    sps2 = sim.run(120)
    m = check_state(sim, N_CONFIG3)
    say("main", f"config[3] next 120 steps: {sps2:.2f} steps/s, "
        f"{sps2 * N_CONFIG3:.4g} particle-steps/s, clamped {m['clamped']}, "
        f"mean density {m['mean_density']:.3f}, max speed "
        f"{m['max_speed']:.4f} | {card}")

    # Small 2D scene through the kernels and through the plain versions.
    runs = {}
    for use_kernels in (True, False):
        s = FluidSimulation.from_scene(
            "dam_break_2d", n_target=300, dense_k=4, cell_factor=1.2,
            rebin_every=3, use_pallas=use_kernels, substeps=6, device=dev)
        n0 = s.metrics()["n_particles"]
        s.run(60)
        runs[use_kernels] = (check_state(s, n0), s.particles()[0], s.dstate)
    (mk, pk, dk), (mp, pp, dp) = runs[True], runs[False]
    if (mk["dropped"], mk["clamped"]) != (mp["dropped"], mp["clamped"]):
        raise AssertionError("2D kernel vs plain counters differ")
    np.testing.assert_allclose(pk.mean(0), pp.mean(0), atol=5e-3)
    np.testing.assert_allclose(pk.std(0), pp.std(0), atol=5e-3)
    same = all(torch.equal(getattr(dk, f), getattr(dp, f))
               for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho"))
    say("main", f"2D {len(pk)} particles, 60 steps, kernels vs plain: centroid "
        f"and spread within 5e-3, bitwise equal state: {same}")

    # 5. times at config[3] shapes
    d, p, spec = sim.dstate, sim.params, sim.spec
    pr2 = d.prs / (d.rho * d.rho)
    irho = torch.reciprocal(d.rho)
    pairs = {
        "density": (
            lambda: density_sweep(d.px, d.py, d.pz, d.occ, p, spec),
            lambda: dense.density_raw(d.px, d.py, d.pz, p, spec)),
        "accel": (
            lambda: accel_sweep(d, pr2, p, spec),
            lambda: dense.accel_raw(d, irho, pr2, p, spec)),
        "rebin_stage": (
            lambda: staged_rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz,
                                 p, spec),
            lambda: dense.rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz,
                                p, spec)),
    }
    rows = []
    for name, (kern, plain) in pairs.items():
        # Turns plain, kernel, kernel, plain on one card.
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        say("times", f"{name}: kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), "
            f"plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}) at "
            f"{list(d.px.shape)} | {card}")
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
        })
    say("times", "rebin_stage times are one whole rebin: 3 stage launches "
        "+ the sentinel cleanup, against the plain rebin")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
