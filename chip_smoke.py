"""GPU smoke test of the PyTorch + CUDA port (sph_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (nonzero exit):

1. device    — needs CUDA; prints the card's name and power limit.
2. build     — builds the hand-written kernels from `sph_tpu_torch/csrc/`
               (one nvcc per source, all at once).
3. kernels   — the fluid kernels against their plain PyTorch versions at
               config[3] shapes (a 1,005,312-particle state stepped 30
               steps) and at a small 2D spec: density and accel bitwise on
               occupied slots and +0 on empty ones (and within rtol 1e-5 /
               atol 1e-6·max|x|), with their band plans; the rebin bitwise
               with equal `dropped` > 0 under a crowding nudge, and
               bitwise with equal `dropped` on the config[3] state with a
               NaN, a +inf and a −inf coordinate (NaN as NaN).
4. main      — config[3] through FluidSimulation for 60 steps = 10 rebins,
               launch counters reset just before: count conserved, dropped
               == 0, positions finite and in bounds, every sweep and both
               passes of every rebin (codes, placement) launched through
               the kernels. Then a small 2D scene through the kernels
               against the plain versions.
5. fluid phases — where the time of a config[3] step goes (CUDA events
               per phase; K1/K2 split into their gate and sweep launches
               and K3 into its codes and placement launches by
               torch.profiler), one step by host clock, and the device's
               busy share under torch.profiler.
6. colony kernels — the 1,048,576-cell bonded colony (bench.py's largest
               colony rung) built from scratch: the contact sweep (K4)
               against its plain version on every slot (rtol 1e-5 / atol
               1e-6·max|x|), asserted bitwise with +0 on empty slots, on
               the settled colony and on a copy compressed ×0.7 about its
               centre (contacts must occur), with its band plan and listed
               bands; the pack's placement (K5) bitwise at 1M, at the
               expand probe's scene (n=400, k=4, spawn 10) and at a crowded
               scene whose cells overflow, with dead rows.
7. colony main — 40 steps of the 1M colony through
               Simulation(scan_chunk=20).step, two chunks through
               run_steps with the adhesion BondPlan carried (1,818,624 bond
               rows, past use_bond_plan's threshold), counters reset just
               before: 40 contact and 40 expand launches, the plan built
               once and the quiet planned branch taken on all 40 steps,
               count conserved, overflow 0, bonds not grown, positions
               finite; then the same 40 steps with adhesion_plan "off",
               held to the planned run after each chunk: bond table and
               count bitwise, positions within rtol 1e-4 / atol
               1e-5·max|x|, kinetic energy within rtol 1e-3, and each
               field's largest difference against the verification lane's
               tolerance printed; steps/s both ways.
8. colony divisions — the reference scenario (tools/make_golden_trace.py
               parameters) on the dense kernel path for 1,000 steps: the
               population at every 50-step mark equals the golden trace's.
9. colony phases — where the time of a 1M step goes (CUDA events per
               phase), the host synchronisations of one step, and the
               device's busy share under torch.profiler; then the planned
               adhesion: the plan build, the planned accumulate, a quiet
               and a hybrid one (500 changed bonds, held to the plain sum),
               a planned and a plain step by host clock, the host reads of
               a quiet planned step, and the peak memory of each step and
               each accumulate.
9b. bond plan — the plan and the planned sums of a 4,096-cell colony
               built on the card, bitwise those built on the CPU; then
               tools/probe_bondplan.py's crossover sweep (10,000 to
               320,000 cells): ms a step plain and planned (host clock),
               and ms of each accumulate alone (CUDA events), with each
               bond capacity.
10. grid     — the sort+gather grid path, which launches no kernel (the
               launch counters stay 0 across it): config[0]
               (dam_break_2d, 4,096 particles) through make_sph_step, 2 ×
               20 steps, one step's density and accel against the
               brute-force twins (tests/test_sph.py's tolerances); then
               bench.py's 10,240-cell grid colony, 240 steps through
               Simulation.step in chunks of 120, its contact forces
               against the brute force (atol 1e-4); a CUDA-event split
               of each (sort, bins, candidate gather, pair sums).
11. host     — the reference scene from its shipped capacity 4 with
               auto_grow on the grid for 1,000 steps against the golden
               population (at least two resizes); a checkpoint round trip
               of the 10k grid colony stepped 20 steps on each side,
               bitwise; GuardedRun halting on an injected NaN (restored
               bitwise to the last good state, the dump loads) and
               recovering under rollback.
12. shard    — the sharded paths (sph_tpu_torch/parallel): config[4]
               (dam_break_3d, 4,012,092 particles, [234, 8, 16384]) 45
               steps on one device; K1 and K2 on its halo-padded blocks
               (a 4-ring's [61, 8, 16384], a 2×2 mesh's [119, 8, 10240])
               and K4 on the 1M colony's, bitwise to their plain versions,
               timed against them beside their bounds. Then one world of 4
               ranks sharing the card over gloo (halos through pinned host
               buffers): config[4] on a 4-ring and a 2×2 mesh, 45 steps
               each, every block bitwise to one device with its counters,
               K1/K2 45 launches a rank and K3 none; checkpoints saved on
               the ring and loaded on one device, and the reverse, each 15
               more steps bitwise; the random fluid of tests/test_dist.py
               at 262,144 particles, 12 steps on the ring (population
               conserved, particles crossing seams); the 1M colony (5
               steps) and the division window of tests/test_dist.py (8
               steps) through Simulation(mesh=…) on both meshes, every
               rank bitwise to one device, K4/K5 a launch a step on every
               rank. A one-rank nccl world runs config[3] 12 steps
               bitwise; a world whose rank raises must fail. Steps/s,
               halo and staged bytes and host-staging ms are those of
               ranks sharing one card, not a multi-GPU speed.
13. times    — each kernel's ms against its plain version's (and, for the
               placement, one PyTorch index_copy), beside its bound; K4
               also on the compressed copy, K5 also at the probe's
               scene.
14. kernel floor — K4 run one stage at a time (ops/contact_floor.py: the
               stubs of tools/probe_kernel_floor.py as stage modes of
               csrc/contact_sweep.cu) at the 1M colony after its main run
               and at that probe's 102,400-cell colony, counters reset
               just before: each mode once on each (2 launches a mode);
               each stub bitwise to its plain version at the band's rows
               and "full" to contact_sweep, also on the 1M colony
               compressed ×0.7; each mode's ms, plain ms, bound and device
               time by kernel, and the split of K4's device time into the
               empty launch, staging and pads, screen and pair terms.
15. verify   — the hardware verification lane (utils/verify.py: JAX's
               seven twin checks) on the card.
16. render   — FluidSimulation.render_frame (800×450) of the config[3]
               state: twice on the card bitwise, within atol 1e-4 of the
               port's render of the same state copied to the CPU, finite,
               in [0, 1], brightest pixel > 0.3; a CUDA-event split
               (projection, the size classes' segment sums, blur, tone
               map, readback); the z-buffer at config[3] and the sphere
               impostors and z-buffer at bench.py's 10,240-cell dense
               colony, each twice bitwise and against the CPU. No kernel
               is launched.
17. viewer   — ViewerLoop(800×450, 4 substeps) on the 10k dense colony
               for 30 scripted frames (press on a cell's pixel, move three
               times, hold, release), counters reset just before: the
               pick equals a brute-force ray test's, the dragged cell
               closes on its target, drag_slot is -1 after release, and
               the contact and expand kernels launched 4 times a frame;
               frames/s and a per-frame split (stepping, impostor,
               readback, overlay commands, rasterisation, PNG encoding);
               one frame written as a PNG and read back bitwise.
18. app      — `python -m sph_tpu_torch.app` in process: `fluid` at
               config[3]'s scene and particle count (30 steps, a frame
               every 15), counters reset just before: exit 0, two frames,
               `dropped` 0, and the sweeps and the rebin launched as many
               times as the steps it ran ask; then `cells` with
               --render-every and `view` with a script at their default
               sizes; and utils.profiling.step_breakdown at config[3].
19. bench    — `python -m sph_tpu_torch.bench --all --cells --breakdown`
               (the port's counterpart of bench.py) as a subprocess with
               its own time limit, its stderr streamed: one JSON line on
               stdout, no rung in error, config[3] with all 1,005,312
               particles alive and none dropped, each rung's kernel
               launches those of its warm and timed steps (BENCH_RUNGS),
               no cell overflow on the dense colonies, the lane ok, the
               8-way dryrun (8 ranks sharing the card over gloo) ok, the
               line's device the card's nvidia-smi name and power limit,
               and config[3]'s steps/s within 0.5-2x of the main phase's;
               the ladder printed, best and median steps/s a rung.

The line before the last is {"kernels": [...]}, preceded by the card's
`nvidia-smi` name and power limit; the last line is {"ok": true, ...}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sph_tpu_torch.utils.profiling import F32_FLOPS, HBM_BYTES_PER_S

CONFIG3 = dict(n_target=1_000_000, cell_factor=1.38, dense_k=8,
               rebin_every=6)
N_CONFIG3 = 1_005_312
MAIN_STEPS = 60
# bench.py's largest colony rung (`_bench_cells`, bench.py:151-157, 323).
COLONY_N = 1_048_576
COLONY_KW = dict(neighbor_mode="dense", grid_dim=48, grid_cell_size=4.0,
                 cell_capacity=16, max_splits_per_step=64, dense_k=2,
                 use_pallas=True)
COLONY_STEPS, COLONY_CHUNK = 40, 20
DIVISION_STEPS = 1000
GOLDEN = "tests/golden/reference_scenario_trace.json"
# Config[0] (`_bench_2d_bruteforce`, bench.py:88-104: sph_step's
# sort+gather) and bench.py's 10k grid colony rung (bench.py:151-157, 319).
CONFIG0_N, CONFIG0_STEPS = 4096, 20
GRID_COLONY_N = 10_240
GRID_COLONY_KW = dict(neighbor_mode="grid", grid_dim=48, grid_cell_size=4.0,
                      cell_capacity=16, max_splits_per_step=64)
GRID_STEPS, GRID_CHUNK = 240, 120
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "density": ("sph_tpu_torch/csrc/fluid_sweep.cu",
                "sph_tpu/ops/pallas/fluid.py:124"),
    "accel": ("sph_tpu_torch/csrc/fluid_sweep.cu",
              "sph_tpu/ops/pallas/fluid.py:124"),
    "rebin": ("sph_tpu_torch/csrc/rebin.cu",
              "sph_tpu/ops/pallas/rebin.py:39"),
    "contact": ("sph_tpu_torch/csrc/contact_sweep.cu",
                "sph_tpu/ops/pallas/contact.py:64"),
    "expand": ("sph_tpu_torch/csrc/expand_rows.cu",
               "sph_tpu/ops/pallas/expand.py:80"),
    # K4's floor modes: the stubs tools/probe_kernel_floor.py swaps into
    # the Pallas contact sweep.
    "floor_zero": ("sph_tpu_torch/csrc/contact_sweep.cu",
                   "tools/probe_kernel_floor.py:78"),
    "floor_pads": ("sph_tpu_torch/csrc/contact_sweep.cu",
                   "tools/probe_kernel_floor.py:84"),
    "floor_screen": ("sph_tpu_torch/csrc/contact_sweep.cu",
                     "tools/probe_kernel_floor.py:105"),
}
# tools/probe_kernel_floor.py's scene: a settled 102,400-cell colony with
# the 1M colony's parameters, packed once.
FLOOR_N = 102_400
# bench.py's 10k dense colony rung (bench.py:318-324): the viewer's scene.
VIEW_COLONY_N = 10_240
VIEW_W, VIEW_H, VIEW_SUBSTEPS, VIEW_FRAMES = 800, 450, 4, 30
# Operations per candidate pair, counted from the pair code: the poly6
# term with its two accumulations, the pressure + viscosity term with its
# six, the contact overlap screen, and the contact terms past the screen.
DENSITY_PAIR_FLOPS = 14
ACCEL_PAIR_FLOPS = 42
CONTACT_SCREEN_FLOPS = 14
CONTACT_PAIR_FLOPS = 110
# The floor's pads stub: 30 adds and a multiply per slot of a gated band.
FLOOR_PADS_FLOPS = 31
# Calls a timing takes of a kernel and of its plain version (`turns`).
TURN_REPS_KERN, TURN_REPS_PLAIN = 20, 3


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


# What the bounds count. Each output plane is written in full and the
# occupancy plane is read in full; an empty slot's other fields are its
# pack fill, known without a read. So a position-type field is read only
# on the occupied slots that have an occupied partner in the stencil, and
# the colony's velocity and spin only on slots in a contact pair.


def fluid_pairs(d, spec) -> tuple[int, int, int]:
    """(occupied slot pairs the Newton-halved sweep visits, each unordered
    pair once; occupied slots with an occupied partner; occupied slots),
    counted over the plain version's variants."""
    from sph_tpu_torch.sph import dense

    occ = d.occ > 0.5
    near = torch.zeros_like(occ)
    n = 0
    for dz, dy, dxs, ms, _mirror, _dest in dense.sweep_groups(spec):
        for dx in dxs:
            o = dy * spec.X + dx
            for m in ms:
                v = (dz, m, o)
                pair = occ & torch.roll(occ, tuple(-a for a in v), (0, 1, 2))
                n += int(pair.sum())
                near |= pair | torch.roll(pair, v, (0, 1, 2))
    return n, int(near.sum()), int(occ.sum())


def contact_work(fields, occ, params, spec) -> dict:
    """What the contact sweep must do on a packed colony: `screens`, the
    (slot, variant) pairs with both slots occupied; `hits`, those with a
    positive margin, which need the full terms; `near`, occupied slots
    with an occupied partner; `touching`, slots in a pair with a hit."""
    from sph_tpu_torch.physics import contact_dense as cd

    F = torch.stack([fields[i] for i in (0, 1, 2, 9)])
    live = occ > 0.5
    near = torch.zeros_like(live)
    touching = torch.zeros_like(live)
    screens = hits = 0
    for dz, dy, o in cd.contact_variants(spec):
        v = (dz, dy, o)
        q = torch.roll(F, (-dz, -dy, -o), (1, 2, 3))
        both = live & torch.roll(live, (-dz, -dy, -o), (0, 1, 2))
        m = cd.contact_screen(params, F[0], F[1], F[2], F[3],
                              q[0], q[1], q[2], q[3])
        hit = both & (m > 0)
        screens += int(both.sum())
        hits += int(hit.sum())
        near |= both
        touching |= hit | torch.roll(hit, v, (0, 1, 2))
    return {"occupied": int(live.sum()), "screens": screens, "hits": hits,
            "near": int(near.sum()), "touching": int(touching.sum())}


def band_line(d, spec) -> str:
    """The sweeps' band plan and how many of its bands the gate lists
    (those holding an occupied slot)."""
    from sph_tpu_torch.ops.fluid import band_plan

    plan = band_plan(spec)
    rows = (d.occ > 0.5).any(dim=1).view(spec.n0, spec.n1, spec.X).any(dim=2)
    pad = plan.bands * plan.rows - spec.n1
    live = torch.nn.functional.pad(rows, (0, pad)).view(
        spec.n0, plan.bands, plan.rows).any(dim=2)
    return (f"band plan {plan}; {int(live.sum())} of {live.numel()} bands "
            f"hold an occupied slot")


def contact_band_line(occ, spec) -> str:
    """K4's band plan and how many of its bands the gate lists (those
    holding an occupied slot)."""
    from sph_tpu_torch.ops.contact import band_plan

    plan = band_plan(spec)
    rows = (occ > 0.5).any(dim=2)
    pad = plan.bands * plan.rows - spec.ny
    live = torch.nn.functional.pad(rows, (0, pad)).view(
        spec.nz, plan.bands, plan.rows).any(dim=2)
    return (f"band plan {plan}; {int(live.sum())} of {live.numel()} bands "
            f"hold an occupied slot")


def exact_contact(where: str, r: dict) -> None:
    """K4 must equal its plain version bit for bit on every slot and hold
    +0 on empty ones."""
    if not (r["bitwise"] and r["empty_zero"] and r["max_abs_err"] == 0):
        raise AssertionError(f"{where} contact: not exact: {r}")


def exact_sweeps(where: str, checks: dict) -> None:
    """K1 and K2 must equal their plain versions bit for bit on occupied
    slots and hold +0 on empty ones."""
    for name in ("density", "accel"):
        r = checks[name]
        if not (r["bitwise"] and r["empty_zero"] and r["max_abs_err"] == 0):
            raise AssertionError(f"{where} {name}: not exact: {r}")


def nonfinite_rebin(d, p, spec) -> dict:
    """K3 against the plain rebin on `d` with three occupied slots' x, y
    and z set to NaN, +inf and −inf (ROADMAP C1): equal bits on every
    field (NaN as NaN: the card's arithmetic gives its canonical NaN where
    K3 copies the input's; −0 == +0) and equal `dropped`."""
    from sph_tpu_torch.ops.rebin import staged_rebin
    from sph_tpu_torch.sph import dense

    occupied = torch.nonzero((d.occ > 0.5).reshape(-1))[:, 0]
    picks = occupied[torch.tensor([0, occupied.numel() // 2, -1],
                                  device=occupied.device)]
    fields = {f: getattr(d, f).clone() for f in ("px", "py", "pz")}
    for f, slot, v in zip(("px", "py", "pz"), picks.tolist(),
                          (float("nan"), float("inf"), float("-inf"))):
        fields[f].view(-1)[slot] = v
    args = (fields["px"], fields["py"], fields["pz"], d.vx, d.vy, d.vz, p,
            spec)
    a, b = dense.rebin(d, *args), staged_rebin(d, *args)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ"):
        x, y = getattr(a, f), getattr(b, f)
        same = ((x.view(torch.int32) == y.view(torch.int32))
                | (x.isnan() & y.isnan()) | ((x == 0) & (y == 0)))
        if not bool(same.all()):
            raise AssertionError(f"non-finite rebin {f}: "
                                 f"{int((~same).sum())} slots differ")
    da, db = int(a.dropped - d.dropped), int(b.dropped - d.dropped)
    if da != db:
        raise AssertionError(f"non-finite rebin dropped: plain {da} != "
                             f"kernel {db}")
    return {"bitwise": True, "dropped": da,
            "nan_slots": int(b.px.isnan().sum())}


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
        if ("registers" in line or "spill" in line
                or "Compiling entry function" in line):
            say("build", line.strip())

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **CONFIG3)
    say("kernels", f"config[3] packed: {N_CONFIG3} particles, layout "
        f"{list(sim.dstate.px.shape)} ({time.perf_counter() - t0:.1f} s)")
    sim.run(30)
    checks = check_fluid_twins(sim.dstate, sim.params, sim.spec, seed=0)
    exact_sweeps("config[3]", checks)
    say("kernels", f"config[3] {band_line(sim.dstate, sim.spec)}")
    for name, r in checks.items():
        say("kernels", f"config[3] {name}: {json.dumps(r)}")
    s2 = FluidSimulation.from_scene("dam_break_2d", n_target=4096,
                                    dense_k=4, cell_factor=1.2,
                                    rebin_every=3, substeps=6, device=dev)
    s2.run(6)
    checks2 = check_fluid_twins(s2.dstate, s2.params, s2.spec, seed=1)
    exact_sweeps("2D", checks2)
    say("kernels", f"2D {band_line(s2.dstate, s2.spec)}")
    for name, r in checks2.items():
        say("kernels", f"2D {list(s2.dstate.px.shape)} {name}: "
            f"{json.dumps(r)}")
    say("kernels", f"config[3] rebin with non-finite coordinates: "
        f"{json.dumps(nonfinite_rebin(sim.dstate, sim.params, sim.spec))}")

    # 4. main path: config[3], counters reset just before.
    reset_launches()
    sps = sim.run(MAIN_STEPS)
    launches = dict(LAUNCHES)
    m = check_state(sim, N_CONFIG3)
    rebins = MAIN_STEPS // sim.params.rebin_every
    want = {"density": MAIN_STEPS, "accel": MAIN_STEPS,
            "rebin": 2 * rebins, "contact": 0, "expand": 0}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    say("main", f"config[3] {MAIN_STEPS} steps ({rebins} rebins): "
        f"{sps:.2f} steps/s, {sps * N_CONFIG3:.4g} particle-steps/s, "
        f"clamped {m['clamped']}, launches {launches}")
    sps2 = sim.run(60)
    m = check_state(sim, N_CONFIG3)
    say("main", f"config[3] next 60 steps: {sps2:.2f} steps/s, "
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

    # 5. Where a config[3] step's time goes.
    fluid_phases(sim, card)

    # 6-9. The colony.
    colony = colony_kernels(dev, card)
    colony_launches = colony_main(colony, card)
    colony_divisions(dev, card)
    colony_phases(colony, card)
    bondplan_phase(dev, card)

    # 10-11. The grid path and the host services.
    grid_colony = grid_phase(dev, card)
    host_phase(grid_colony, dev, card)

    # 12. The sharded paths (ranks sharing the card over gloo, and a
    # one-rank nccl world).
    shard_phase(colony, dev, card)

    # 13. times, each kernel at its main path's shapes
    d, p, spec = sim.dstate, sim.params, sim.spec
    plane = d.px.numel() * 4
    n_pairs, n_near, n_occ = fluid_pairs(d, spec)
    pairs = {
        **sweep_time_pairs(d, p, spec, n_pairs, n_near),
        # occupancy in, 7 planes out; 6 payload fields of occupied slots.
        "rebin": (
            lambda: staged_rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz,
                                 p, spec),
            lambda: dense.rebin(d, d.px, d.py, d.pz, d.vx, d.vy, d.vz,
                                p, spec),
            None, bound(8 * plane + 6 * 4 * n_occ, 0)),
        **colony_time_pairs(colony, card),
    }
    say("times", f"config[3] {list(d.px.shape)}: {n_pairs} occupied slot "
        f"pairs in the halved stencil, {n_near} of {n_occ} occupied slots "
        f"with an occupied partner")
    launches.update(colony_launches)
    checks.update(colony["checks"])
    rows = []
    for name, (kern, plain, library_call, bnd) in pairs.items():
        ms, plain_ms, (p1, k1, k2, p2) = turns(kern, plain)
        lib_ms = (None if library_call is None
                  else cuda_ms(library_call, 20))
        say("times", f"{name}: kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), "
            f"plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} | {card}")
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib_ms,
        })
    say("times", "rebin times are one whole rebin: the codes and the "
        "placement launch, against the plain rebin; contact and expand at "
        "the 1M colony after its main run")

    # 14-15. K4's floor modes (their own path, counters reset just
    # before it), and the verification lane.
    rows += floor_phase(colony, dev, card)
    verify_phase(card)

    # 16-18. The render and host layers.
    view_colony = render_phase(sim, dev, card)
    viewer_phase(view_colony, card)
    app_phase(sim, card)

    # 19. The port's bench, the whole ladder, in its own process.
    bench_phase(sps, card)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def device_busy(run, card) -> str:
    """Wall and device-busy ms of run() under torch.profiler, with the
    busy share, or a note that the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            busy_us += float(getattr(e, "self_device_time_total", 0.0) or
                             getattr(e, "self_cuda_time_total", 0.0))
    if busy_us <= 0:
        return "profiler reported no device time: busy share not measured"
    return (f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
            f"busy share {busy_us / 1e3 / (wall * 1e3):.3f} | {card}")


def fluid_phases(sim, card) -> None:
    """Phase 5: CUDA-event times of each part of a config[3] step (on the
    state after the main run), the K1/K2/K3 launches by kernel under
    torch.profiler, one step by host clock and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
    from sph_tpu_torch.ops.rebin import staged_rebin
    from sph_tpu_torch.sph import dense
    from sph_tpu_torch.sph.model import eos_pressure

    d, p, spec = sim.dstate, sim.params, sim.spec
    raw = density_sweep(d.px, d.py, d.pz, d.occ, p, spec)
    rho = dense.density_fixup(raw, d.occ, p)
    d = d.replace_fields(rho=rho, prs=torch.where(
        d.occ > 0.5, eos_pressure(rho, p), 0.0))
    pr2 = d.prs / (d.rho * d.rho)
    acc = accel_sweep(d, pr2, p, spec)
    vmax = dense.rebin_vmax(p, spec)
    moved = dense._integrate(d, *acc, p, vmax)[:6]
    phases = {
        "K1 density sweep": lambda: density_sweep(d.px, d.py, d.pz, d.occ,
                                                  p, spec),
        "density fixup + EOS": lambda: torch.where(
            d.occ > 0.5, eos_pressure(dense.density_fixup(raw, d.occ, p), p),
            0.0),
        "p/rho^2": lambda: d.prs / (d.rho * d.rho),
        "K2 accel sweep": lambda: accel_sweep(d, pr2, p, spec),
        "_integrate (gravity, obstacle, drag, vmax clamp, walls)":
            lambda: dense._integrate(d, *acc, p, vmax),
        "one rebin (K3: codes + placement)": lambda: staged_rebin(
            d, *moved, p, spec),
    }
    total = 0.0
    for name, fn in phases.items():
        ms = cuda_ms(fn, 10)
        total += ms / p.rebin_every if name.startswith("one rebin") else ms
        say("fluid phases", f"{name}: {ms:.4f} ms")
    for name, fn in (("K1", phases["K1 density sweep"]),
                     ("K2", phases["K2 accel sweep"]),
                     ("K3", phases["one rebin (K3: codes + placement)"])):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if us > 0:
                say("fluid phases", f"{name} by kernel: {e.key[:48]}: "
                    f"{us / 10 / 1e3:.4f} ms per call")
    sps = sim.run(12)
    say("fluid phases", f"sum of phases (rebin / {p.rebin_every}) "
        f"{total:.4f} ms; one step (host clock, 12 steps) {1e3 / sps:.4f} ms"
        f" | {card}")
    check_state(sim, N_CONFIG3)
    say("fluid phases", f"profiled {p.rebin_every} steps: "
        f"{device_busy(lambda: sim.run(p.rebin_every), card)}")


# -- the colony -------------------------------------------------------------


def colony_kernels(dev, card) -> dict:
    """Phase 5: build the 1M colony, hold K4 and K5 to their plain
    versions on it (settled and compressed) and K5 at the probe scene."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import (
        blob,
        check_contact,
        check_expand,
        compressed,
    )

    t0 = time.perf_counter()
    state, params, genome = bonded_colony(COLONY_N, device=dev, **COLONY_KW)
    spec = cd.make_contact_spec(params, k=params.dense_k,
                                cell_factor=params.dense_cell_factor)
    n_bonds = int(state.bonds.active.sum())
    say("colony kernels", f"{COLONY_N} cells, {n_bonds} bonds (capacity "
        f"{params.max_bonds}), layout {list(spec.shape())} ({spec.slots} "
        f"slots), built in {time.perf_counter() - t0:.1f} s")
    contact = check_contact(state, params, spec)
    exact_contact("settled", contact)
    say("colony kernels", f"contact, settled: {json.dumps(contact)}")
    squeezed = compressed(state, 0.7)
    contact_c = check_contact(squeezed, params, spec)
    exact_contact("compressed", contact_c)
    say("colony kernels", f"contact, compressed x0.7: "
        f"{json.dumps(contact_c)}")
    if contact_c["contact_slots"] == 0:
        raise AssertionError("compressed colony has no contact: the pair "
                             "math was not exercised")
    occ = cd._pack_args(state, spec)[1]
    say("colony kernels", f"contact {contact_band_line(occ, spec)}")
    expand = check_expand(state, spec)
    say("colony kernels", f"expand at 1M: {json.dumps(expand)}")
    # The expand probe's scene (tools/repro_expand.py): 400 cells in a
    # radius-9 ball, k = 4, spawn radius 10, drawn with numpy (seed 3).
    s6, _, spec6 = blob(n=400, k=4, seed=3, radius=9.0, spawn=10.0,
                        radii=(2.0, 2.0), device=dev)
    expand6 = check_expand(s6, spec6)
    say("colony kernels", f"expand at the probe scene {list(spec6.shape())}:"
        f" {json.dumps(expand6)}")
    # Crowded: 50,000 cells in a radius-20 ball (~14 a cell, K = 2), the
    # last 1,000 rows dead.
    s7, _, spec7 = blob(n=50_000, k=2, seed=7, radius=20.0, spawn=22.0,
                        alive=49_000, device=dev)
    expand7 = check_expand(s7, spec7)
    if expand7["overflow"] == 0 or expand7["dead"] != 1_000:
        raise AssertionError(f"crowded scene: no overflow or wrong dead "
                             f"rows: {expand7}")
    say("colony kernels", f"expand at a crowded scene "
        f"{list(spec7.shape())}: {json.dumps(expand7)} | {card}")
    return {"state": state, "params": params, "genome": genome,
            "spec": spec, "bonds": n_bonds, "probe": (s6, spec6),
            "checks": {"contact": contact_c if contact_c["max_abs_err"]
                       > contact["max_abs_err"] else contact,
                       "expand": expand}}


def colony_main(colony, card) -> dict:
    """Phase 6: 40 steps of the 1M colony through Simulation(scan_chunk=20)
    — two chunks through run_steps, the adhesion plan carried (its bond
    table is past use_bond_plan's threshold) — launch and plan counters
    reset just before; then the same 40 steps with adhesion_plan "off",
    held to the planned run after each chunk (held_to_plain)."""
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.physics import adhesion as adh

    def run(params):
        sim = Simulation(colony["genome"], params, scan_chunk=COLONY_CHUNK,
                         device=colony["state"].device)
        sim.state = colony["state"]
        chunks = []
        torch.cuda.synchronize()
        reset_launches()
        adh.reset_plan_counts()
        t0 = time.perf_counter()
        for _ in range(COLONY_STEPS // COLONY_CHUNK):
            sim.step(COLONY_CHUNK)
            chunks.append(sim.state)
        torch.cuda.synchronize()
        return (sim, COLONY_STEPS / (time.perf_counter() - t0),
                dict(LAUNCHES), dict(adh.PLAN_COUNTS), chunks)

    sim, sps, launches, plans, planned = run(colony["params"])
    m = sim.metrics()
    want = {"density": 0, "accel": 0, "rebin": 0,
            "contact": COLONY_STEPS, "expand": COLONY_STEPS}
    if launches != want:
        raise AssertionError(f"colony launches {launches} != {want}")
    # The plan is built once and every step takes the quiet branch: a
    # settled colony changes no bond.
    want_plans = {"quiet": COLONY_STEPS, "hybrid": 0, "full": 0,
                  "builds": 1}
    if plans != want_plans:
        raise AssertionError(f"colony plan path {plans} != {want_plans}")
    if m["active_particles"] != COLONY_N:
        raise AssertionError(f"colony count {m['active_particles']}")
    if m["overflow"] != 0:
        raise AssertionError(f"colony overflow {m['overflow']}")
    if m["bond_count"] > colony["bonds"]:
        raise AssertionError(f"bonds grew: {m['bond_count']} > "
                             f"{colony['bonds']}")
    if not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError("non-finite colony positions")
    say("colony main", f"{COLONY_N} cells, {COLONY_STEPS} steps in chunks "
        f"of {COLONY_CHUNK}, planned adhesion: {sps:.2f} steps/s, "
        f"{sps * COLONY_N:.4g} cell-steps/s, bonds {colony['bonds']} -> "
        f"{m['bond_count']}, overflow {m['overflow']}, max speed "
        f"{m['max_speed']:.4f}, launches {launches}, plan {plans} | {card}")

    _, sps_off, launches_off, plans_off, plain = run(
        colony["params"].replace(adhesion_plan="off"))
    if plans_off != {"quiet": 0, "hybrid": 0, "full": 0, "builds": 0}:
        raise AssertionError(f"plan used with adhesion_plan off: {plans_off}")
    say("colony main", f"the same {COLONY_STEPS} steps with adhesion_plan "
        f"off: {sps_off:.2f} steps/s (planned {sps:.2f}), launches "
        f"{launches_off} | {card}")
    for k, (a, b) in enumerate(zip(plain, planned)):
        held_to_plain(a, b, (k + 1) * COLONY_CHUNK)
    colony["sim"] = sim
    return {"contact": launches["contact"], "expand": launches["expand"]}


# utils/verify.check_planned_adhesion's tolerances (rtol, atol).
PLANNED_TOL = {"vel": (1e-4, 1e-5), "rot": (1e-4, 1e-4)}


def kinetic_energy(st) -> float:
    n = int(st.active_count)
    v = st.vel[:n].double()
    return float(0.5 * (st.mass[:n].double() * (v * v).sum(-1)).sum())


def held_to_plain(a, b, steps: int) -> None:
    """The planned run's state `b` against the plain run's `a` after
    `steps` steps. Asserted: count and bond table bitwise, positions
    within tests/test_torch_simulation.py's rtol 1e-4 / atol
    1e-5·max|x|, kinetic energy within its rtol 1e-3. Printed: each float
    field's largest difference and its ratio to the verification lane's
    tolerance. The lane holds velocities and spins at n = 4,096; at the
    1M colony (|x| up to ~300, where one position ulp is 3e-5) a
    reassociated sum's rounding grows past that absolute tolerance within
    a few steps, in velocities through the springs and in the spins
    through the orientation constraint's rounding-noise axis."""
    for f in ("active", "slot_a", "slot_b", "zone_a", "zone_b"):
        if not torch.equal(getattr(a.bonds, f), getattr(b.bonds, f)):
            raise AssertionError(f"planned vs plain: bonds.{f} differ")
    if int(a.active_count) != int(b.active_count):
        raise AssertionError("planned vs plain: counts differ")
    n = int(a.active_count)
    out = {}
    for f in ("pos", "vel", "rot", "ang_vel"):
        x, y = getattr(a, f)[:n], getattr(b, f)[:n]
        rtol, atol = PLANNED_TOL.get(f, (1e-4, 1e-5 * float(x.abs().max())))
        d = (x - y).abs()
        ratio = torch.where(d > 0, d / (atol + rtol * x.abs()), 0.0)
        out[f] = {"max_abs_diff": float(d.max()),
                  "worst_ratio": float(ratio.max()),
                  "rtol": rtol, "atol": atol}
    ke = (kinetic_energy(a), kinetic_energy(b))
    say("colony main", f"planned vs plain after {steps} steps: bond table "
        f"and count bitwise; kinetic energy {ke[1]:.6g} vs {ke[0]:.6g}; "
        f"{json.dumps(out)}")
    if out["pos"]["worst_ratio"] > 1:
        raise AssertionError(f"planned vs plain positions after {steps} "
                             f"steps: {out['pos']}")
    if abs(ke[1] - ke[0]) > 1e-3 * abs(ke[0]):
        raise AssertionError(f"planned vs plain kinetic energy after "
                             f"{steps} steps: {ke}")


def colony_divisions(dev, card) -> None:
    """Phase 7: the reference scenario on the dense kernel path; the
    population schedule depends only on the division timers, so it must
    follow the golden trace exactly."""
    from sph_tpu_torch.engine.config import (
        reference_genome,
        reference_scene_params,
    )
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches

    golden = {g["step"]: g["n"] for g in json.load(open(GOLDEN))}
    p = reference_scene_params(capacity=512).replace(
        dt=1 / 60, max_splits_per_step=256, max_bonds=2048,
        neighbor_mode="dense", use_pallas=True)
    sim = Simulation(reference_genome(), p, seed=0, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    seen = []
    for _ in range(DIVISION_STEPS // 50):
        sim.step(50)
        m = sim.metrics()
        if m["active_particles"] != golden[m["step"]]:
            raise AssertionError(
                f"step {m['step']}: population {m['active_particles']} != "
                f"golden {golden[m['step']]}")
        seen.append(m["active_particles"])
    elapsed = time.perf_counter() - t0
    if LAUNCHES["contact"] != DIVISION_STEPS:
        raise AssertionError(f"division run launches {dict(LAUNCHES)}")
    if not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError("non-finite positions in the division run")
    say("colony divisions", f"{DIVISION_STEPS} steps, population at each "
        f"50-step mark {seen} = golden; bonds {m['bond_count']}, overflow "
        f"{m['overflow']}; {DIVISION_STEPS / elapsed:.1f} steps/s | {card}")


def colony_phases(colony, card) -> None:
    """Phase 8: CUDA-event times of each phase of a 1M step, the host
    synchronisations of one step, and the profiler's busy share."""
    from sph_tpu_torch.biology import bonds, division
    from sph_tpu_torch.engine.step import step
    from sph_tpu_torch.ops.contact import contact_sweep
    from sph_tpu_torch.ops.expand import expand_rows
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.physics import adhesion as adh
    from sph_tpu_torch.physics.adhesion import apply_adhesion
    from sph_tpu_torch.physics.contact import apply_contact
    from sph_tpu_torch.physics.drag import apply_drag_force
    from sph_tpu_torch.physics.integrate import update_motion, update_rotation

    sim = colony["sim"]
    st, p, g, spec = sim.state, sim.params, sim.genome_dev, colony["spec"]
    rows, flat, fits, key, ovr, slot_of = cd._sort_with_payload(st, spec)
    packed = expand_rows(rows, key, cd.PACK_FILLS, spec)
    fields = [packed[c].view(spec.shape()) for c in range(10)]
    occ = packed[10].view(spec.shape())
    comps = contact_sweep(fields, occ, p, spec)
    f, t, _ = cd.gather_back([c.reshape(-1) for c in comps], slot_of, ovr)
    adh_args, adh_segs = adh.bond_inputs(st, p, g)
    adh_deltas = adh.bond_pair_deltas(*adh_args)
    phases = {
        "pack sort (cell ids, stable sort, row gather, ranks)":
            lambda: cd._sort_with_payload(st, spec),
        "K5 expand": lambda: expand_rows(rows, key, cd.PACK_FILLS, spec),
        "K4 contact sweep": lambda: contact_sweep(fields, occ, p, spec),
        "gather back": lambda: cd.gather_back(
            [c.reshape(-1) for c in comps], slot_of, ovr),
        "apply contact": lambda: apply_contact(st, p, f, t),
        "adhesion (gathers, pair math, sorted segment sum)":
            lambda: apply_adhesion(st, p, g),
        "- of which the pair math (bond_pair_deltas)":
            lambda: adh.bond_pair_deltas(*adh_args),
        "- of which the sorted segment sum": lambda: adh.accumulate_bond_deltas(
            *adh_deltas, *adh_segs, st.capacity),
        "drag + motion + rotation": lambda: update_rotation(
            update_motion(apply_drag_force(st, p), p), p),
        "division + bond upkeep (gates)": lambda: bonds.filter_bonds(
            st.replace_fields(bonds=bonds.update_bond_zones(
                division.queue_splits(division.process_pending_splits(
                    st, p, g), p, g), p, g))),
    }
    total = 0.0
    for name, fn in phases.items():
        ms = cuda_ms(fn, 5)
        total += 0.0 if name.startswith("-") else ms
        say("colony phases", f"{name}: {ms:.4f} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        st = step(st, p, g)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    say("colony phases", f"sum of phases {total:.4f} ms; one step (host "
        f"clock, 5 steps) {step_ms:.4f} ms | {card}")
    syncs = host_syncs(lambda: step(st, p, g))
    say("colony phases", f"host synchronisations in one quiet step: "
        f"{len(syncs)} at {syncs}")

    def five_steps(s=st):
        for _ in range(5):
            s = step(s, p, g)

    say("colony phases", f"profiled 5 steps: {device_busy(five_steps, card)}")
    planned_phases(st, p, g, adh_deltas, adh_segs, card)


def host_syncs(fn) -> list:
    """The host synchronisations fn() makes, as file:line."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def peak_mb(fn) -> float:
    """Peak device memory allocated while fn() runs, in MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e6


def drifted(bonds, n_rows: int, n: int, seed: int = 0):
    """The bond table with `n` active bonds' A endpoint moved to another
    slot: a stale plan's changed bonds, as a division leaves them."""
    gen = torch.Generator(device=bonds.slot_a.device).manual_seed(seed)
    live = torch.nonzero(bonds.active)[:, 0]
    pick = live[torch.randperm(live.numel(), generator=gen,
                               device=live.device)[:n]]
    slot_a = bonds.slot_a.clone()
    slot_a[pick] = torch.randint(0, n_rows, (n,), generator=gen,
                                 device=live.device, dtype=slot_a.dtype)
    return bonds.replace_fields(slot_a=slot_a)


def planned_phases(st, p, g, deltas, segs, card) -> None:
    """The planned adhesion accumulate at the 1M colony: the plan build,
    the quiet planned accumulate, a hybrid one with 500 changed bonds (held
    to the plain sum of the drifted table), a planned step by host clock
    against a plain one, the host reads of a quiet planned step, and peak
    memory of each step."""
    from sph_tpu_torch.engine.step import run_steps, step
    from sph_tpu_torch.physics import adhesion as adh

    N = st.capacity
    plan = adh.build_bond_plan(st.bonds, N)
    moved = drifted(st.bonds, N, 500)
    n_changed = int(adh.plan_changed_count(moved, plan))
    seg_a, seg_b = adh._segments(moved, N)
    adh.reset_plan_counts()
    got = adh.accumulate_bond_deltas_hybrid(*deltas, moved, N, plan)
    if adh.PLAN_COUNTS["hybrid"] != 1:
        raise AssertionError(f"hybrid branch not taken: {adh.PLAN_COUNTS}")
    want = adh.accumulate_bond_deltas(*deltas, seg_a, seg_b, N)
    for x, y, name in zip(got, want, ("dv", "dq")):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=2e-5, atol=1e-6,
                                   err_msg=f"hybrid accumulate {name}")
    phases = {
        "plan build (stable sort of the 2B endpoint rows, run ends)":
            lambda: adh.build_bond_plan(st.bonds, N),
        "planned accumulate (row gather, segmented scan, run totals)":
            lambda: adh.accumulate_bond_deltas_planned(*deltas, plan),
        "quiet hybrid accumulate (the changed count read, then planned)":
            lambda: adh.accumulate_bond_deltas_hybrid(*deltas, st.bonds, N,
                                                      plan),
        f"hybrid accumulate, {n_changed} changed bonds (side table of "
        f"{adh._SIDE_CAP})":
            lambda: adh.accumulate_bond_deltas_hybrid(*deltas, moved, N,
                                                      plan),
        "plain accumulate (sorted segment sum), for comparison":
            lambda: adh.accumulate_bond_deltas(*deltas, *segs, N),
    }
    for name, fn in phases.items():
        say("colony phases", f"{name}: {cuda_ms(fn, 5):.4f} ms")

    def planned_step():
        return run_steps(st, p, g, 1, bond_plan=plan)

    def plain_step():
        return step(st, p, g)

    for name, fn in (("planned", planned_step), ("plain", plain_step)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        say("colony phases", f"one {name} step (host clock, 5 "
            f"steps from the same state) "
            f"{(time.perf_counter() - t0) / 5 * 1e3:.4f} ms")
    syncs = host_syncs(planned_step)
    say("colony phases", f"host synchronisations in one quiet planned step "
        f"(run_steps with the plan): {len(syncs)} at {syncs}")
    base = torch.cuda.memory_allocated() / 1e6
    plan_mb = sum(t.numel() * t.element_size()
                  for t in vars(plan).values()) / 1e6
    peaks = [peak_mb(fn) for fn in (
        planned_step, plain_step,
        lambda: adh.accumulate_bond_deltas_planned(*deltas, plan),
        lambda: adh.accumulate_bond_deltas(*deltas, *segs, N))]
    say("colony phases", f"peak device memory: one step planned "
        f"{peaks[0]:.1f} MB, plain {peaks[1]:.1f} MB; the accumulate alone "
        f"planned {peaks[2]:.1f} MB, plain {peaks[3]:.1f} MB ({base:.1f} MB "
        f"allocated before each; the plan {plan_mb:.1f} MB) | {card}")


# tools/probe_bondplan.py's colony sizes up to 320,000 cells, each
# settled colony stepped SWEEP_STEPS steps a call through run_steps.
SWEEP_SIZES = (10_000, 20_000, 40_000, 80_000, 102_400, 160_000, 320_000)
SWEEP_STEPS, SWEEP_ROUNDS = 10, 5
PLAN_CHECK_N = 4096


def bondplan_phase(dev, card) -> list:
    """The planned adhesion's crossover on the card: ms a step of the
    plain and the planned path (run_steps, the plan built once a call, as
    tools/probe_bondplan.py times it) at each size with its bond capacity;
    and on a 4,096-cell colony the plan and the planned sums built on the
    card bitwise to those built on the CPU."""
    import dataclasses as dc

    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.step import run_steps, use_bond_plan
    from sph_tpu_torch.physics import adhesion as adh

    st, p, g = bonded_colony(PLAN_CHECK_N, device="cpu", **COLONY_KW)
    cpu_plan = adh.build_bond_plan(st.bonds, st.capacity)
    cuda_plan = adh.build_bond_plan(
        st.bonds.replace_fields(**{f.name: getattr(st.bonds, f.name).to(dev)
                                   for f in dc.fields(st.bonds)}),
        st.capacity)
    for f in dc.fields(cpu_plan):
        if not torch.equal(getattr(cuda_plan, f.name).cpu(),
                           getattr(cpu_plan, f.name)):
            raise AssertionError(f"bond plan {f.name}: card != CPU")
    args, _ = adh.bond_inputs(st, p, g.to_device("cpu"))
    deltas = adh.bond_pair_deltas(*args)
    want = adh.accumulate_bond_deltas_planned(*deltas, cpu_plan)
    got = adh.accumulate_bond_deltas_planned(
        *[d.to(dev) for d in deltas], cuda_plan)
    for x, y, name in zip(got, want, ("dv", "dq")):
        if not torch.equal(x.cpu().view(torch.int32),
                           y.view(torch.int32)):
            raise AssertionError(f"planned {name}: card != CPU")
    say("bond plan", f"{PLAN_CHECK_N}-cell colony: the plan "
        f"({cpu_plan.perm.numel()} sorted rows) and the planned sums built "
        f"on the card are bitwise those built on the CPU")

    rows = []
    for n in SWEEP_SIZES:
        st, p, g = bonded_colony(n, device=dev, **COLONY_KW)
        gd = g.to_device(dev)
        row = {"n": n, "bonds": int(st.bonds.active.sum()),
               "bond_capacity": st.bonds.capacity,
               "auto_plans": use_bond_plan(p, st)}
        for mode in ("off", "on"):
            pm = p.replace(adhesion_plan=mode)
            run_steps(st, pm, gd, SWEEP_STEPS)          # warm-up
            best = float("inf")
            for _ in range(SWEEP_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_steps(st, pm, gd, SWEEP_STEPS)
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) / SWEEP_STEPS
                           * 1e3)
            row["ms_plain" if mode == "off" else "ms_plan"] = best
        row["plan_wins"] = row["ms_plan"] < row["ms_plain"]
        args, segs = adh.bond_inputs(st, p, gd)
        deltas = adh.bond_pair_deltas(*args)
        plan = adh.build_bond_plan(st.bonds, st.capacity)
        row["accumulate_ms_plain"] = cuda_ms(
            lambda: adh.accumulate_bond_deltas(*deltas, *segs, st.capacity),
            10)
        row["accumulate_ms_plan"] = cuda_ms(
            lambda: adh.accumulate_bond_deltas_planned(*deltas, plan), 10)
        say("bond plan", json.dumps(row))
        rows.append(row)
    say("bond plan", f"crossover: ms a step (best of {SWEEP_ROUNDS} runs of "
        f"{SWEEP_STEPS} steps, host clock ending in a synchronise, the plan "
        f"built once a run), ms of an accumulate (CUDA events, 10 calls) "
        f"| {card}")
    return rows


# -- the grid path and the host services -----------------------------------


def assert_no_launches(where: str) -> None:
    from sph_tpu_torch.ops import LAUNCHES

    if any(LAUNCHES.values()):
        raise AssertionError(f"{where}: kernels launched {dict(LAUNCHES)}")


def timed_steps(run, n: int) -> float:
    """Steps/s of run() (n steps), host clock ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def grid_phase(dev, card):
    """Phase 10: config[0] through make_sph_step and the 10k grid colony
    through Simulation.step, each held to its brute-force twin on the
    card, with a CUDA-event split; no kernel is launched."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.ops import reset_launches
    from sph_tpu_torch.ops import grid
    from sph_tpu_torch.physics.contact import contact_forces_bruteforce
    from sph_tpu_torch.sph import model
    from sph_tpu_torch.sph.scenes import dam_break_2d
    from sph_tpu_torch.utils.verify import compressed

    reset_launches()
    state, p = dam_break_2d(n_target=CONFIG0_N)
    n = state.pos.shape[0]
    f = model.make_sph_step(p, substeps=CONFIG0_STEPS, device=dev)
    box = [state]

    def run():
        box[0] = f(box[0])

    sps = [timed_steps(run, CONFIG0_STEPS) for _ in range(2)]
    st = box[0]
    spec = p.grid_spec()
    rho_g, ovf = model.compute_density(st, p)
    rho_b = model.compute_density_bruteforce(st, p)
    np.testing.assert_allclose(rho_g.cpu().numpy(), rho_b.cpu().numpy(),
                               rtol=1e-5)
    st2 = dataclasses.replace(st, density=rho_g,
                              pressure=model.eos_pressure(rho_g, p))
    acc_g = model.compute_accel(st2, p)
    acc_b = model.compute_accel_bruteforce(st2, p)
    np.testing.assert_allclose(acc_g.cpu().numpy(), acc_b.cpu().numpy(),
                               rtol=2e-4, atol=2e-3)
    pos = st.pos.cpu().numpy()
    lo = np.asarray(p.bounds_min, np.float32)[:2]
    hi = np.asarray(p.bounds_max, np.float32)[:2]
    if int(st.bin_overflow) != 0 or int(ovf) != 0:
        raise AssertionError(f"config[0] bin overflow {int(st.bin_overflow)}")
    if not (np.isfinite(pos).all() and (pos[:, :2] >= lo).all()
            and (pos[:, :2] <= hi).all()):
        raise AssertionError("config[0] positions non-finite or outside "
                             "the tank")
    say("grid", f"config[0] {n} particles, grid {list(spec.dim)} x "
        f"{spec.cell_capacity}: 2 x {CONFIG0_STEPS} steps at "
        f"{sps[0]:.2f} / {sps[1]:.2f} steps/s ({sps[1] * n:.4g} "
        f"particle-steps/s), step {int(st.step_count)}, bin overflow 0; "
        f"density and accel within rtol 1e-5 / rtol 2e-4 atol 2e-3 of the "
        f"brute force | {card}")
    order, bins = grid.sort_by_cell(st.pos, spec)
    pos_s, vel_s = st.pos[order], st.vel[order]
    coords = grid.cell_coords(pos_s, spec)
    rho = model._density_sorted(pos_s, coords, bins, spec, p)
    prs = model.eos_pressure(rho, p)
    split = {
        "sort (cell ids, stable sort, starts)":
            lambda: grid.sort_by_cell(st.pos, spec),
        "candidate gather (stencil_candidates_sorted, all rows)":
            lambda: grid.stencil_candidates_sorted(coords, bins, spec),
        "density pair sums (with their gather)":
            lambda: model._density_sorted(pos_s, coords, bins, spec, p),
        "accel pair sums (with their gather)":
            lambda: model._accel_sorted(pos_s, vel_s, rho, prs, coords,
                                        bins, spec, p),
        "sph_step": lambda: model.sph_step(st, p),
    }
    for name, fn in split.items():
        say("grid", f"config[0] {name}: {cuda_ms(fn, 10):.4f} ms")
    say("grid", f"config[0] profiled {CONFIG0_STEPS} steps: "
        f"{device_busy(run, card)}")

    t0 = time.perf_counter()
    cstate, cp, genome = bonded_colony(GRID_COLONY_N, device=dev,
                                       **GRID_COLONY_KW)
    bonds0 = int(cstate.bonds.active.sum())
    sim = Simulation(genome, cp, device=dev)
    sim.state = cstate
    built = time.perf_counter() - t0
    csps = [timed_steps(lambda: sim.step(GRID_CHUNK), GRID_CHUNK)
            for _ in range(GRID_STEPS // GRID_CHUNK)]
    m = sim.metrics()
    if m["active_particles"] != GRID_COLONY_N or m["overflow"] != 0:
        raise AssertionError(f"grid colony count {m['active_particles']}, "
                             f"overflow {m['overflow']}")
    if m["bond_count"] > bonds0:
        raise AssertionError(f"grid colony bonds grew: {m['bond_count']} > "
                             f"{bonds0}")
    if not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError("non-finite grid colony positions")
    # Settled, no pair touches: hold the sums on a copy compressed ×0.7
    # about the centre too, where contacts fire.
    contact = {}
    for name, cstate in (("settled", sim.state),
                         ("compressed x0.7", compressed(sim.state, 0.7))):
        fg, tg, covf = grid.contact_forces_grid(cstate, cp)
        fb, tb = contact_forces_bruteforce(cstate, cp)
        np.testing.assert_allclose(fg.cpu().numpy(), fb.cpu().numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(tg.cpu().numpy(), tb.cpu().numpy(),
                                   atol=1e-4)
        contact[name] = (f"max |f| {float(fb.abs().max()):.4g}, grid "
                         f"overflow {int(covf)}")
    if contact["compressed x0.7"].startswith("max |f| 0,"):
        raise AssertionError("compressed grid colony has no contact")
    gspec = grid.GridSpec.from_params(cp)
    say("grid", f"grid colony {GRID_COLONY_N} cells, {bonds0} bonds, grid "
        f"{list(gspec.dim)} x {gspec.cell_capacity} (built in {built:.1f} "
        f"s): {GRID_STEPS} steps in chunks of {GRID_CHUNK} at "
        + " / ".join(f"{x:.2f}" for x in csps)
        + f" steps/s ({csps[-1] * GRID_COLONY_N:.4g} cell-steps/s), "
        f"overflow 0, bonds {bonds0} -> {m['bond_count']}; contact forces "
        f"within atol 1e-4 of the brute force ({contact}) | {card}")
    from sph_tpu_torch.physics.contact import alive_mask

    cs = sim.state
    alive = alive_mask(cs)
    ccoords = grid.cell_coords(cs.pos, gspec)
    cbins = grid.build_bins(cs.pos, alive, gspec)
    blocks = list(grid.row_blocks(cs.capacity, 2048, dev))
    cands = [grid.stencil_candidates(ccoords[r], cbins, gspec)
             for r in blocks]
    split = {
        "sort (cell ids, stable sort)": lambda: torch.argsort(
            grid.cell_ids(grid.cell_coords(cs.pos, gspec), gspec),
            stable=True),
        "bins (sort, ranks, placement)": lambda: grid.build_bins(
            cs.pos, alive, gspec),
        "candidate gather (stencil_candidates, all blocks)": lambda: [
            grid.stencil_candidates(ccoords[r], cbins, gspec)
            for r in blocks],
        "pair sums (block_contact_sums, all blocks)": lambda: [
            grid.block_contact_sums(cs, cp, r, c, alive)
            for r, c in zip(blocks, cands)],
        "contact_forces_grid": lambda: grid.contact_forces_grid(cs, cp),
    }
    for name, fn in split.items():
        say("grid", f"grid colony {name}: {cuda_ms(fn, 10):.4f} ms")
    one = 1e3 / timed_steps(lambda: sim.step(10), 10)
    say("grid", f"grid colony one step (host clock, 10 steps) {one:.4f} ms"
        f" | {card}")
    say("grid", f"grid colony profiled 10 steps: "
        f"{device_busy(lambda: sim.step(10), card)}")
    assert_no_launches("grid phase")
    return sim


def host_phase(grid_sim, dev, card) -> None:
    """Phase 11: auto-grow on the golden population, a checkpoint round
    trip of the 10k grid colony, and GuardedRun on the card."""
    import tempfile

    from sph_tpu_torch.core.types import state_to_numpy
    from sph_tpu_torch.engine.config import (
        reference_genome,
        reference_scene_params,
    )
    from sph_tpu_torch.engine.recovery import (
        GuardedRun,
        SimulationFault,
        fault_flag,
    )
    from sph_tpu_torch.engine.simulation import Simulation

    golden = {g["step"]: g["n"] for g in json.load(open(GOLDEN))}
    p = reference_scene_params().replace(
        dt=1 / 60, max_splits_per_step=4, max_bonds=2048,
        neighbor_mode="grid")
    sim = Simulation(reference_genome(), p, seed=0, auto_grow=True,
                     device=dev)
    grows = []
    resize = sim.resize

    def logged(n):
        before = sim.state.capacity
        resize(n)
        if sim.state.capacity != before:
            grows.append((int(sim.state.step_count), before,
                          sim.state.capacity))

    sim.resize = logged
    t0 = time.perf_counter()
    seen = []
    for _ in range(DIVISION_STEPS // 50):
        sim.step(50)
        m = sim.metrics()
        if m["active_particles"] != golden[m["step"]]:
            raise AssertionError(
                f"auto-grow step {m['step']}: population "
                f"{m['active_particles']} != golden {golden[m['step']]}")
        seen.append(m["active_particles"])
    elapsed = time.perf_counter() - t0
    if len(grows) < 2 or not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError(f"auto-grow: resizes {grows}")
    say("host", f"reference scene from capacity {p.capacity}, auto_grow, "
        f"grid, {DIVISION_STEPS} steps: population at each 50-step mark "
        f"{seen} = golden; resizes (step, from, to) {grows}; overflow "
        f"{m['overflow']}; {DIVISION_STEPS / elapsed:.1f} steps/s | {card}")
    assert_no_launches("host phase, auto-grow")

    def same(a, b) -> bool:
        x, y = state_to_numpy(a), state_to_numpy(b)
        return all(np.array_equal(x[k], y[k]) for k in x)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid_colony.npz")
        grid_sim.save(path)
        copy = Simulation.load(path, device=dev)
        if not same(copy.state, grid_sim.state):
            raise AssertionError("checkpoint: loaded state differs")
        grid_sim.step(20)
        copy.step(20)
        if not same(copy.state, grid_sim.state):
            raise AssertionError("checkpoint: 20 steps after the load "
                                 "differ from the original's")
        say("host", f"checkpoint of the {GRID_COLONY_N}-cell grid colony "
            f"({os.path.getsize(path)} bytes): loaded bitwise, and bitwise "
            f"after 20 more steps on each side")

        start = int(grid_sim.state.step_count)
        grid_sim.save(path)

        def injector(at, always=False):
            fired = []

            def inject(s, step):
                if step >= at and (always or not fired):
                    fired.append(step)
                    vel = s.state.vel.clone()
                    vel[0, 0] = float("nan")
                    s.state = s.state.replace_fields(vel=vel)
            return inject

        ref = Simulation.load(path, device=dev)
        ref.step(20)
        halted = Simulation.load(path, device=dev)
        dump = os.path.join(tmp, "crash.npz")
        guard = GuardedRun(halted, chunk=10, policy="halt", dump_path=dump,
                           inject=injector(start + 20))
        try:
            guard.run(60)
            raise AssertionError("GuardedRun did not halt on the NaN")
        except SimulationFault as e:
            if e.good_step != start + 20 or not same(halted.state,
                                                     ref.state):
                raise AssertionError(f"halt: restored to {e.good_step}, "
                                     f"not bitwise the good state")
        if int(fault_flag(Simulation.load(dump, device=dev).state)) != 1:
            raise AssertionError("halt: the crash dump is not the fault")
        rolled = Simulation.load(path, device=dev)
        guard = GuardedRun(rolled, chunk=10, policy="rollback",
                           dump_path=None, inject=injector(start + 20))
        guard.run(40)
        ref.step(20)
        if len(guard.faults) != 1 or not same(rolled.state, ref.state):
            raise AssertionError(f"rollback: faults {guard.faults}, state "
                                 f"not bitwise a clean run's")
        say("host", f"GuardedRun on the grid colony: halt at step "
            f"{start + 30} restored bitwise to step {start + 20}, the dump "
            f"loads with its fault; rollback recovered a one-off fault and "
            f"equals a clean run bitwise at step "
            f"{int(rolled.state.step_count)} | {card}")
    assert_no_launches("host phase")


# -- the render and host layers ---------------------------------------------


def host_copy(sim):
    """A FluidSimulation on the CPU holding a copy of `sim`'s state, as
    FluidSimulation.load builds one."""
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.utils.convert import state_from_numpy

    host = FluidSimulation.__new__(FluidSimulation)
    host.params, host.spec, host.mesh = sim.params, sim.spec, None
    host._start(state_from_numpy(
        {f.name: getattr(sim.dstate, f.name).cpu().numpy()
         for f in dataclasses.fields(sim.dstate)}, device="cpu"),
        sim._step, sim.substeps)
    return host


def repeat_and_hold(name: str, card_fn, cpu_value, atol: float) -> None:
    """card_fn() twice on the card, bitwise equal, and within atol of the
    CPU's value on the same inputs (inf where the CPU has inf)."""
    a, b = card_fn(), card_fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two renders on the card differ in "
                             f"{int((a != b).sum())} values")
    got, want = a.cpu().numpy(), cpu_value.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    finite = np.isfinite(want)
    err = float(np.abs(got[finite] - want[finite]).max(initial=0.0))
    say("render", f"{name} {list(a.shape)}: twice bitwise on the card; max "
        f"|card - CPU| {err:.3g} (atol {atol:g})")


def render_phase(sim, dev, card) -> dict:
    """Phase 16: render_frame of config[3], the z-buffer, and the sphere
    impostors of the 10k dense colony, each held against the CPU and
    repeated bitwise, with a CUDA-event split of the splat frame."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.fluid import tank_camera
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.core.types import state_from_numpy, state_to_numpy
    from sph_tpu_torch.ops import reset_launches
    from sph_tpu_torch.render import splat
    from sph_tpu_torch.render.image import frame_bytes
    from sph_tpu_torch.render.overlay import cells_image, default_camera
    from sph_tpu_torch.sph import dense

    reset_launches()
    w, h = VIEW_W, VIEW_H
    host = host_copy(sim)
    img = sim.render_frame(width=w, height=h)
    repeat_and_hold("config[3] render_frame",
                    lambda: sim.render_frame(width=w, height=h),
                    host.render_frame(width=w, height=h), 1e-4)
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and float(img.max()) <= 1.0 and float(img.max()) > 0.3):
        raise AssertionError(f"config[3] frame: min {float(img.min())}, "
                             f"max {float(img.max())}")
    vp = tank_camera(sim.params).view_params()
    pos, _, _, _, mask = dense.unpack(sim.dstate)
    hpos, _, _, _, hmask = dense.unpack(host.dstate)
    repeat_and_hold("config[3] zbuffer",
                    lambda: splat.zbuffer(pos, vp, w, h, mask=mask),
                    splat.zbuffer(hpos, vp, w, h, mask=hmask), 0.0)

    # The split of one frame, each part on the previous part's output.
    eye, right, up, fwd, tanf = splat.camera_tensors(vp, dev)
    radius = torch.full((pos.shape[0],), sim.params.h * 0.5,
                        dtype=torch.float32, device=dev)

    def project():
        p, r = splat._drop_masked(mask, pos, radius)
        px, py, z, vis = splat.project_points(p, eye, right, up, fwd, tanf,
                                              w, h)
        return (splat.pixel_ids(px, py, vis, w, h), z, vis,
                splat.depth_colors(z, vis), r)

    pid, z, vis, colors, r = project()
    sums = splat.splat_sums(pid, z, vis, colors, w, h, tanf, r)
    blurred = splat.blur_classes(sums, r)
    toned = splat.tone_map(blurred)
    parts = {
        "drop masked slots, project, pixel ids, depth colours": project,
        "segment sums (4 size classes, one stable sort)":
            lambda: splat.splat_sums(pid, z, vis, colors, w, h, tanf, r),
        "blur (4 classes, 2 depthwise convs each)":
            lambda: splat.blur_classes(sums, r),
        "tone map": lambda: splat.tone_map(blurred),
        "readback (uint8 bytes to the host)": lambda: frame_bytes(toned),
        "render_frame (all of the above but the readback)":
            lambda: sim.render_frame(width=w, height=h),
    }
    n_vis = int(vis.sum())
    for name, fn in parts.items():
        say("render", f"config[3] {name}: {cuda_ms(fn, 10):.4f} ms")
    say("render", f"config[3] frame: {pos.shape[0]} slots, "
        f"{int(mask.sum())} occupied, {n_vis} in view; classes "
        f"{[int(x) for x in (sums.sum(dim=(1, 2, 3)) > 0)]} lit | {card}")

    t0 = time.perf_counter()
    state, params, genome = bonded_colony(VIEW_COLONY_N, device=dev,
                                          **COLONY_KW)
    csim = Simulation(genome, params, device=dev)
    csim.state = state
    chost = Simulation(genome, params, device="cpu")
    chost.state = state_from_numpy(state_to_numpy(state), device="cpu")
    cam = default_camera(csim)
    say("render", f"{VIEW_COLONY_N}-cell dense colony built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{int(state.bonds.active.sum())} bonds")
    repeat_and_hold("colony render_spheres",
                    lambda: cells_image(csim, cam, w, h),
                    cells_image(chost, cam, w, h), 1e-4)
    cvp = cam.view_params()
    cmask = (torch.arange(state.capacity, device=dev) < state.active_count)
    def zbuffer():
        return splat.zbuffer(state.pos, cvp, w, h, mask=cmask)

    repeat_and_hold("colony zbuffer", zbuffer,
                    splat.zbuffer(chost.state.pos, cvp, w, h,
                                  mask=cmask.cpu()), 0.0)
    say("render", f"colony render_spheres: "
        f"{cuda_ms(lambda: cells_image(csim, cam, w, h), 10):.4f} ms, "
        f"zbuffer {cuda_ms(zbuffer, 10):.4f} ms | {card}")
    assert_no_launches("render phase")
    return {"sim": csim, "bonds": int(state.bonds.active.sum())}


def brute_pick(pos: np.ndarray, origin, d, r: float) -> int:
    """The slot a ray through (origin, d) meets first among spheres of
    radius r, in float64: the viewer's pick, computed independently."""
    o, d = np.float64(origin), np.float64(d)
    rel = pos.astype(np.float64) - o
    along = rel @ d
    miss2 = np.einsum("ij,ij->i", rel, rel) - along * along
    hit = (along >= 0) & (miss2 <= r * r)
    t = np.where(hit, along - np.sqrt(np.maximum(r * r - miss2, 0.0)),
                 np.inf)
    return int(np.argmin(t)) if np.isfinite(t).any() else -1


def viewer_phase(colony, card) -> None:
    """Phase 17: a scripted ViewerLoop session on the 10k dense colony,
    its frame rate and a per-frame split, and one frame as a PNG."""
    import tempfile

    from sph_tpu_torch.app.viewer import ViewerLoop
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.render import overlay, raster
    from sph_tpu_torch.render.image import encode_png, frame_bytes, read_png

    sim = colony["sim"]
    w, h = VIEW_W, VIEW_H
    v = ViewerLoop(sim, width=w, height=h, substeps=VIEW_SUBSTEPS)
    n = int(sim.state.active_count)
    pos = sim.state.pos[:n].cpu().numpy()
    px, py, vis = overlay._project(pos, v.camera, w, h)
    # The cell in view nearest the frame's centre.
    near = np.where(vis, (px - w / 2) ** 2 + (py - h / 2) ** 2, np.inf)
    cell = int(np.argmin(near))
    x, y = int(round(float(px[cell]))), int(round(float(py[cell])))
    want = brute_pick(pos, *v.camera.pixel_ray(x, y, w, h),
                      sim.params.max_radius)
    script = {0: [{"type": "mouse_down", "x": x, "y": y}],
              1: [{"type": "mouse_move", "x": x + 40, "y": y}],
              2: [{"type": "mouse_move", "x": x + 80, "y": y}],
              3: [{"type": "mouse_move", "x": x + 120, "y": y - 20}],
              VIEW_FRAMES - 1: [{"type": "mouse_up"}]}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(VIEW_FRAMES):
        frame = v.frame(script.get(i, []))
        if i == 0 and v.drag_slot != want:
            raise AssertionError(f"pick at ({x}, {y}): slot {v.drag_slot}, "
                                 f"brute force {want}")
        if i == 3:
            slot = v.drag_slot
            target = sim.state.drag_input.target.cpu().numpy()
            gap0 = float(np.linalg.norm(
                sim.state.pos[slot].cpu().numpy() - target))
        if i == VIEW_FRAMES - 2:
            gap1 = float(np.linalg.norm(
                sim.state.pos[slot].cpu().numpy() - target))
    elapsed = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    per = VIEW_SUBSTEPS * VIEW_FRAMES
    if launches != {"density": 0, "accel": 0, "rebin": 0, "contact": per,
                    "expand": per}:
        raise AssertionError(f"viewer launches {launches}, want {per} "
                             f"contact and expand")
    if not gap1 < gap0:
        raise AssertionError(f"dragged cell {slot}: gap to its target "
                             f"{gap0} -> {gap1}")
    if v.drag_slot != -1 or int(sim.state.drag_input.selected_slot) != -1:
        raise AssertionError("drag not released")
    if not bool(torch.isfinite(sim.state.pos).all()):
        raise AssertionError("non-finite positions in the viewer run")
    say("viewer", f"{VIEW_COLONY_N} cells, {colony['bonds']} bonds, "
        f"{VIEW_FRAMES} frames x {VIEW_SUBSTEPS} substeps: pick ({x}, {y}) "
        f"-> slot {want} = brute force; dragged gap {gap0:.3f} -> "
        f"{gap1:.3f}; released; launches {launches}; "
        f"{VIEW_FRAMES / elapsed:.2f} frames/s by host clock (loop's own "
        f"fps {v.fps:.2f}) | {card}")

    # The split of a frame: each part synchronised, 10 frames.
    split = {k: 0.0 for k in ("step", "impostor", "readback",
                              "overlay inputs (bond_lines, ids)",
                              "overlay commands", "rasterise",
                              "PNG encode")}
    sizes = []
    for _ in range(10):
        marks = [time.perf_counter()]
        sim.step(VIEW_SUBSTEPS)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        img = overlay.cells_image(sim, v.camera, w, h)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        arr = frame_bytes(img)
        marks.append(time.perf_counter())
        inputs = overlay.overlay_inputs(sim, False, True, False)
        marks.append(time.perf_counter())
        cmds = overlay.overlay_commands(v.camera, w, h, show_anchors=True,
                                        **inputs)
        marks.append(time.perf_counter())
        raster.rasterize(arr, cmds)
        marks.append(time.perf_counter())
        sizes.append(len(encode_png(arr)))
        marks.append(time.perf_counter())
        for k, a, b in zip(split, marks, marks[1:]):
            split[k] += (b - a) * 1e3 / 10
    say("viewer", "per-frame split (ms, host clock, synchronised, 10 "
        "frames): " + ", ".join(f"{k} {t:.3f}" for k, t in split.items())
        + f"; sum {sum(split.values()):.3f}; {len(cmds)} draw commands, "
        f"PNG {int(np.mean(sizes))} bytes | {card}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "view.png")
        frame.save(path)
        back = read_png(path)
        if not np.array_equal(back, np.asarray(frame)):
            raise AssertionError("PNG read back differs from the frame")
        say("viewer", f"frame written as PNG ({os.path.getsize(path)} "
            f"bytes) and read back bitwise {list(back.shape)}")


def app_phase(sim, card) -> None:
    """Phase 18: the app's fluid, cells and view commands in process, and
    step_breakdown at config[3]."""
    import contextlib
    import io
    import tempfile

    from sph_tpu_torch.app.__main__ import main as app_main
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.render.image import read_png
    from sph_tpu_torch.utils.profiling import step_breakdown

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = app_main(argv)
        elapsed = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"app {argv}: exit {rc}")
        lines = [json.loads(l) for l in out.getvalue().splitlines()
                 if l.startswith("{")]
        return lines, elapsed

    with tempfile.TemporaryDirectory() as tmp:
        fluid_out = os.path.join(tmp, "fluid")
        torch.cuda.synchronize()
        reset_launches()
        lines, elapsed = run(["fluid", "--scene", "dam_break_3d_obstacle",
                              "--n", "1000000", "--steps", "30",
                              "--render-every", "15", "--out", fluid_out])
        launches = dict(LAUNCHES)
        m = lines[-1]
        steps = m["step"]
        frames = sorted(os.listdir(fluid_out))
        if (m["dropped"] != 0 or m["n_particles"] != N_CONFIG3
                or frames != ["frame_00000.png", "frame_00001.png"]):
            raise AssertionError(f"app fluid: {m}, frames {frames}")
        if not (launches["density"] == launches["accel"] == steps
                and launches["rebin"] > 0 and launches["rebin"] % 2 == 0
                and launches["contact"] == launches["expand"] == 0):
            raise AssertionError(f"app fluid launches {launches} for "
                                 f"{steps} steps")
        shape = read_png(os.path.join(fluid_out, frames[-1])).shape
        say("app", f"fluid dam_break_3d_obstacle --n 1000000: exit 0 in "
            f"{elapsed:.1f} s, {m['n_particles']} particles, {steps} steps "
            f"({m['steps_per_sec']:.2f} steps/s in its last run), dropped "
            f"0, frames {frames} {list(shape)}; launches {launches} | "
            f"{card}")
        reset_launches()
        lines, elapsed = run(["cells", "--render-every", "100", "--out",
                              os.path.join(tmp, "cells")])
        frames = sorted(os.listdir(os.path.join(tmp, "cells")))
        if len(frames) != 6 or lines[-1]["step"] != 600:
            raise AssertionError(f"app cells: {lines[-1]}, frames {frames}")
        say("app", f"cells (capacity 64, 600 steps, a frame every 100): exit"
            f" 0 in {elapsed:.1f} s, {lines[-1]['active_particles']} cells, "
            f"{lines[-1]['bond_count']} bonds, {len(frames)} frames; "
            f"launches {dict(LAUNCHES)}")
        script = os.path.join(tmp, "script.json")
        with open(script, "w") as f:
            json.dump({"0": [{"type": "mouse_down", "x": 400, "y": 225}],
                       "1": [{"type": "mouse_move", "x": 450, "y": 225}],
                       "60": [{"type": "mouse_up"}, {"type": "orbit"}]}, f)
        lines, elapsed = run(["view", "--script", script])
        if lines[-1]["frame"] != 119 or lines[-1]["drag_slot"] != -1:
            raise AssertionError(f"app view: {lines[-1]}")
        say("app", f"view (capacity 64, 120 frames x 4 substeps, scripted):"
            f" exit 0 in {elapsed:.1f} s, last {json.dumps(lines[-1])}")
    bd = step_breakdown(sim.dstate, sim.params, sim.spec)
    say("app", f"step_breakdown at config[3] (CUDA events, best of 4 x 30):"
        f" {json.dumps(bd)} | {card}")


def sweep_time_pairs(d, p, spec, n_pairs: int, n_near: int) -> dict:
    """(kernel, plain, library call, bound) of K1 and K2 on a state (or a
    rank's halo-padded block) with its pair counts (`fluid_pairs`)."""
    from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
    from sph_tpu_torch.sph import dense

    pr2 = d.prs / (d.rho * d.rho)
    irho = torch.reciprocal(d.rho)
    plane = d.px.numel() * 4
    return {
        # occupancy in, density out; 3 positions where a partner is.
        "density": (
            lambda: density_sweep(d.px, d.py, d.pz, d.occ, p, spec),
            lambda: dense.density_raw(d.px, d.py, d.pz, p, spec),
            None, bound(2 * plane + 3 * 4 * n_near,
                        n_pairs * DENSITY_PAIR_FLOPS)),
        # occupancy in, 3 accelerations out; positions, velocities, 1/ρ
        # and p/ρ² where a partner is.
        "accel": (
            lambda: accel_sweep(d, pr2, p, spec),
            lambda: dense.accel_raw(d, irho, pr2, p, spec),
            None, bound(4 * plane + 8 * 4 * n_near,
                        n_pairs * ACCEL_PAIR_FLOPS)),
    }


def turns(kern, plain):
    """(kernel ms, plain ms, the four runs): plain, kernel, kernel, plain
    on one card, the kernel over TURN_REPS_KERN calls, the plain version
    over TURN_REPS_PLAIN."""
    p1 = cuda_ms(plain, TURN_REPS_PLAIN)
    k1 = cuda_ms(kern, TURN_REPS_KERN)
    k2 = cuda_ms(kern, TURN_REPS_KERN)
    p2 = cuda_ms(plain, TURN_REPS_PLAIN)
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def contact_pair(fields, occ, p, spec):
    """(what the sweep must do, (kernel, plain, library call, bound)) of K4
    on packed fields."""
    from sph_tpu_torch.ops.contact import contact_sweep
    from sph_tpu_torch.physics import contact_dense as cd

    w = contact_work(fields, occ, p, spec)
    return w, (
        lambda: contact_sweep(fields, occ, p, spec),
        lambda: cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(p, *a), 6, spec),
        None, bound(*contact_cost(w, occ.numel() * 4)))


def contact_cost(w: dict, plane: int) -> tuple[int, int]:
    """(bytes, operations) K4 must spend on a pack whose work is `w`
    (`contact_work`): occupancy in, 6 components out; position and radius
    where a partner is, velocity and spin where a pair touches; the screens
    of occupied pairs and the terms of touching ones."""
    return (7 * plane + 4 * 4 * w["near"] + 6 * 4 * w["touching"],
            w["screens"] * CONTACT_SCREEN_FLOPS
            + w["hits"] * CONTACT_PAIR_FLOPS)


def expand_pair(state, spec):
    """(kernel, plain, library call, bound) of K5 on a state's pack sort."""
    from sph_tpu_torch.ops.expand import expand_rows
    from sph_tpu_torch.physics import contact_dense as cd

    rows, flat, fits, key, _, _ = cd._sort_with_payload(state, spec)
    base = torch.tensor(cd.PACK_FILLS, dtype=torch.float32,
                        device=rows.device)[:, None].expand(
                            11, spec.slots + 1).contiguous()
    idx = flat.long()
    src = rows.t()
    n = rows.shape[0]
    return (
        lambda: expand_rows(rows, key, cd.PACK_FILLS, spec),
        lambda: cd._scatter_sorted(rows.unbind(1), cd.PACK_FILLS, flat,
                                   fits, spec),
        lambda: torch.index_copy(base, 1, idx, src),
        # keys in, the rows that fit in, 11 planes out.
        bound(n * 4 + int(fits.sum()) * 11 * 4 + 11 * spec.slots * 4, 0))


def colony_time_pairs(colony, card) -> dict:
    """(kernel, plain, library call, bound) of K4 and K5 at the 1M colony
    after its main run. Also times, on their own lines, K4 on the
    compressed copy and K5 at the probe's scene."""
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import compressed

    st, p, spec = colony["sim"].state, colony["sim"].params, colony["spec"]
    fields, occ, _, _ = cd._pack_args(st, spec, expand=True)
    w, contact = contact_pair(fields, occ, p, spec)
    say("times", f"colony {list(spec.shape())}: {json.dumps(w)}")
    fields_c, occ_c, _, _ = cd._pack_args(compressed(st, 0.7), spec,
                                          expand=True)
    w_c, (kern, _, _, bnd) = contact_pair(fields_c, occ_c, p, spec)
    say("times", f"colony compressed x0.7: {json.dumps(w_c)}")
    k1, k2 = cuda_ms(kern, 20), cuda_ms(kern, 20)
    say("times", f"contact compressed x0.7: kernel {(k1 + k2) / 2:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']} | {card}")
    s6, spec6 = colony["probe"]
    kern, plain, library_call, bnd = expand_pair(s6, spec6)
    p1, k1, k2, p2 = (cuda_ms(plain, 20), cuda_ms(kern, 20),
                      cuda_ms(kern, 20), cuda_ms(plain, 20))
    say("times", f"expand at the probe scene {list(spec6.shape())}: kernel "
        f"{(k1 + k2) / 2:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
        f"{(p1 + p2) / 2:.4f} ms, library {cuda_ms(library_call, 20):.4f} "
        f"ms, bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} | {card}")
    return {"contact": contact, "expand": expand_pair(st, spec)}


# -- 14. kernel floor: K4 run one stage at a time ---------------------------


def floor_pairs(fields, occ, p, spec) -> dict:
    """(kernel, plain, library call, bytes, operations) of each of K4's
    floor modes (ops/contact_floor.py) on packed fields, at the band plan's
    rows. Counted as K4's bound counts (`contact_cost`): the zero stub's
    function is six +0 planes, so it writes them and reads nothing; the
    others read the occupancy plane and write 6 planes; the pads read the 10
    fields of the occupied slots within a plane of a gated band, and do 31
    operations a slot of a gated band; the screen reads position and
    radius where an occupied partner is and does the screens of occupied
    pairs; "full" is K4."""
    from sph_tpu_torch.ops import contact_floor as cf
    from sph_tpu_torch.ops.contact import NCOMP, band_plan
    from sph_tpu_torch.physics import contact_dense as cd

    tile = band_plan(spec).rows
    plane = occ.numel() * 4
    gated = cf.tile_gate(occ, tile).expand_as(occ)
    near_gated = gated | torch.roll(gated, 1, 0) | torch.roll(gated, -1, 0)
    read = int(((occ > 0.5) & near_gated).sum())
    w = contact_work(fields, occ, p, spec)

    def stub(mode):
        return (lambda: cf.contact_floor(fields, occ, p, spec, mode),
                lambda: cf.PLAIN[mode](fields, occ, p, spec, tile))

    return {
        # One PyTorch call gives the zero stub's function: six +0 planes.
        "zero": (*stub("zero"), lambda: torch.zeros(
            (NCOMP, *occ.shape), device=occ.device), 6 * plane, 0),
        "pads": (*stub("pads"), None, 7 * plane + 10 * 4 * read,
                 int(gated.sum()) * FLOOR_PADS_FLOPS),
        "screen": (*stub("screen"), None, 7 * plane + 4 * 4 * w["near"],
                   w["screens"] * CONTACT_SCREEN_FLOPS),
        "full": (stub("full")[0], lambda: cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(p, *a), NCOMP, spec),
            None, *contact_cost(w, plane)),
    }


def floor_exact(where: str, outs: dict, fields, occ, p, spec) -> dict:
    """Each stub's outputs bitwise to its plain version at the band's rows
    (+0 and −0 apart, NaN as NaN), "full" to contact_sweep. Returns {mode:
    the max |kernel − plain| over the slots whose bits differ (inf where
    one of the two is NaN), 0 when bitwise}; raises if any slot differs."""
    from sph_tpu_torch.ops import contact_floor as cf
    from sph_tpu_torch.ops.contact import band_plan, contact_sweep

    tile = band_plan(spec).rows
    errs = {}
    for mode, kern in outs.items():
        plain = (contact_sweep(fields, occ, p, spec) if mode == "full"
                 else cf.PLAIN[mode](fields, occ, p, spec, tile))
        n, err = 0, 0.0
        for a, b in zip(kern, plain):
            differ = a.view(torch.int32) != b.view(torch.int32)
            n += int(differ.sum())
            if bool(differ.any()):
                err = max(err, float((a[differ] - b[differ]).abs()
                                     .nan_to_num(nan=float("inf")).max()))
        if n:
            raise AssertionError(f"{where} floor {mode}: {n} slots differ in "
                                 f"their bits, max abs err {err}")
        errs[mode] = err
    return errs


def floor_drive(packs: dict) -> dict:
    """The floor path: every mode once on each pack. Returns {pack:
    {mode: outputs}}."""
    from sph_tpu_torch.ops import contact_floor as cf

    return {name: {mode: cf.contact_floor(fields, occ, p, spec, mode)
                   for mode in cf.MODES}
            for name, (fields, occ, p, spec) in packs.items()}


def host_ms(fn, reps: int = 20) -> float:
    """Host ms a call of fn() takes to enqueue its work, timed without a
    synchronise between calls (after one warm-up call and a
    synchronise)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def device_ms(fn, calls: int = 10) -> dict:
    """Device ms a launch of each kernel fn() launches once a call, under
    torch.profiler, and the launches the profiler recorded of the `calls`
    made ({kernel name: [ms, recorded]}; empty if it saw no device time);
    the mean is over the launches recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name[:56]] = [us / e.count / 1e3, e.count]
    return out


def floor_times(name: str, fields, occ, p, spec, card) -> dict:
    """Each mode's kernel, plain and (zero) library ms (CUDA events) and
    bound on one pack, and its device time by kernel (torch.profiler);
    then the split, from the device times: at the probe's scene a call's
    host work is as long as its kernels, so the events time the host.
    Returns {mode: (ms, plain ms, library ms, bound, device ms)}."""
    out = {}
    for mode, (kern, plain, library_call, nbytes, flops) in floor_pairs(
            fields, occ, p, spec).items():
        ms, plain_ms, (p1, k1, k2, p2) = turns(kern, plain)
        lib_ms = None if library_call is None else cuda_ms(library_call, 20)
        bnd = bound(nbytes, flops)
        by_kernel = device_ms(kern)
        dev_ms = sum(v[0] for v in by_kernel.values()) if by_kernel else None
        out[mode] = (ms, plain_ms, lib_ms, bnd, dev_ms)
        say("kernel floor", f"{name} {mode}: kernel {ms:.4f} ms ({k1:.4f}, "
            f"{k2:.4f}; host enqueue {host_ms(kern):.4f} a call), plain "
            f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}), library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, {nbytes} "
            f"bytes, {flops} operations, bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']}; device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
            f"{json.dumps(by_kernel)} | {card}")
    dev = {mode: v[4] for mode, v in out.items()}
    if None in dev.values():
        say("kernel floor", f"{name} split: not measured (the profiler saw "
            f"no device time)")
        return out
    say("kernel floor", f"{name} split (device ms a call): empty launch "
        f"(zero) {dev['zero']:.4f}; staging and pads (pads - zero) "
        f"{dev['pads'] - dev['zero']:.4f}; staging, list and pass 1 "
        f"(screen - zero) {dev['screen'] - dev['zero']:.4f}; screen - pads "
        f"{dev['screen'] - dev['pads']:.4f}; pair terms (full - screen) "
        f"{dev['full'] - dev['screen']:.4f} (the pads mode also reads the "
        f"six fields the sweep does not stage, and writes a plane) | {card}")
    return out


def floor_phase(colony, dev, card) -> list:
    """Phase 14: K4's floor modes at the 1M colony after its main run and
    at tools/probe_kernel_floor.py's 102,400-cell colony. Counters reset
    just before the floor path (each colony packed through K5, then every
    mode once on each pack) and read just after; then each pack is held
    bitwise to the plain placement, each stub to its plain version at the
    band's rows and "full" to contact_sweep — also on the 1M colony
    compressed ×0.7, where bands hit the screen — and timed, the
    compressed copy too. Returns the
    kernels-line rows of the three stubs, timed at the 1M colony, with the
    largest error their checks measured."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.ops import FLOOR_LAUNCHES, LAUNCHES, reset_launches
    from sph_tpu_torch.ops.contact import band_plan
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import compressed

    t0 = time.perf_counter()
    st, p, spec = colony["sim"].state, colony["sim"].params, colony["spec"]
    small, sp, _ = bonded_colony(FLOOR_N, device=dev, **COLONY_KW)
    sspec = cd.make_contact_spec(sp, k=sp.dense_k,
                                 cell_factor=sp.dense_cell_factor)
    colonies = {"1M colony": (st, p, spec),
                f"{FLOOR_N} colony": (small, sp, sspec)}
    torch.cuda.synchronize()
    reset_launches()
    packs = {name: (*cd._pack_args(s_, sp_, expand=True)[:2], p_, sp_)
             for name, (s_, p_, sp_) in colonies.items()}
    outs = floor_drive(packs)
    torch.cuda.synchronize()
    launches = {**{f"floor_{m}": n for m, n in FLOOR_LAUNCHES.items()},
                "contact": LAUNCHES["contact"],
                "expand": LAUNCHES["expand"]}
    if launches != {"floor_zero": 2, "floor_pads": 2, "floor_screen": 2,
                    "contact": 2, "expand": 2}:
        raise AssertionError(f"floor path launches {launches}")
    errs = {}
    for name, (fields, occ, p_, sp_) in packs.items():
        say("kernel floor", f"{name} {list(sp_.shape())}: "
            f"{contact_band_line(occ, sp_)}")
        plain_fields, plain_occ = cd._pack_args(colonies[name][0], sp_)[:2]
        n = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                for a, b in zip((*fields, occ), (*plain_fields, plain_occ)))
        if n:
            raise AssertionError(f"{name}: K5's pack differs from the plain "
                                 f"placement in {n} slots' bits")
        errs[name] = floor_exact(name, outs[name], fields, occ, p_, sp_)
    fields_c, occ_c = cd._pack_args(compressed(st, 0.7), spec,
                                    expand=True)[:2]
    outs_c = floor_drive({"c": (fields_c, occ_c, p, spec)})["c"]
    errs["compressed"] = floor_exact("1M colony compressed x0.7", outs_c,
                                     fields_c, occ_c, p, spec)
    hits = [int((o["screen"][0] != 0).sum())
            for o in (outs["1M colony"], outs_c)]
    if hits[1] == 0:
        raise AssertionError("compressed colony: no band hit the screen")
    say("kernel floor", f"every stub bitwise to its plain version at the "
        f"band's {band_plan(spec).rows} rows and full to contact_sweep, at "
        f"both colonies and the compressed copy; both packs bitwise to the "
        f"plain placement; launches {launches}; "
        f"slots of bands that hit the screen: settled {hits[0]}, "
        f"compressed {hits[1]} ({time.perf_counter() - t0:.1f} s)")
    times = {name: floor_times(name, *pack, card)
             for name, pack in packs.items()}
    # Where bands hit, pass 2 runs: the split of a colony in contact.
    floor_times("1M colony compressed x0.7", fields_c, occ_c, p, spec, card)
    rows = []
    for mode in ("zero", "pads", "screen"):
        ms, plain_ms, lib_ms, bnd, _ = times["1M colony"][mode]
        name = f"floor_{mode}"
        src, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(e[mode] for e in errs.values()), "ms": ms,
            "plain_ms": plain_ms, **bnd,
            "library_ms": lib_ms,
        })
    return rows


def verify_phase(card) -> None:
    """Phase 15: the hardware verification lane (utils/verify.py, JAX's
    seven twin checks) on the card; any failure fails the run."""
    from sph_tpu_torch.utils.verify import run_all

    t0 = time.perf_counter()
    results = run_all(verbose=True)
    fails = [(n, e) for n, e in results if e is not None]
    say("verify", f"{len(results) - len(fails)}/{len(results)} twin checks "
        f"ok ({time.perf_counter() - t0:.1f} s) | {card}")
    if fails:
        raise AssertionError(f"verify: {fails}")


# -- 19. bench: python -m sph_tpu_torch.bench --all --cells --breakdown -------

# Each rung's steps and the launches they ask for: (steps, substeps or
# chunk, rebin_every) at bench.py's settings (`_bench_dense` 240/60/6,
# `_bench_2d_dense` 480/120/3, config[4] 45/15/6, `_bench_cells` 240/120
# and 40/20 at 1M); a fluid rung launches K1 and K2 once a step and K3
# twice a rebin, a dense colony K4 and K5 once a step, over one warm and
# steps // substeps timed calls.
BENCH_RUNGS = {
    "2D dam-break 4k (brute-force executable spec)": None,
    "2D splash/pour 32k (dense grid + Pallas)": ("fluid", 480, 120, 3),
    "3D dam-break 256k (dense grid + Pallas)": ("fluid", 240, 60, 6),
    "3D dam-break + SDF obstacle 1M (dense grid + Pallas)":
        ("fluid", 240, 60, 6),
    "3D dam-break 4M single-chip + 8-way decomposition dryrun":
        ("fluid", 45, 15, 6),
    "cell colony 10k (contact+adhesion, grid)": None,
    "cell colony 10k (contact+adhesion, dense)": ("cells", 240, 120, 0),
    "cell colony 100k (contact+adhesion, dense)": ("cells", 240, 120, 0),
    "cell colony 1M (contact+adhesion, dense)": ("cells", 40, 20, 0),
}
BENCH_CONFIG3 = "3D dam-break + SDF obstacle 1M (dense grid + Pallas)"
BENCH_CONFIG4 = "3D dam-break 4M single-chip + 8-way decomposition dryrun"
BENCH_TIMEOUT = 600


def bench_launches(rung) -> dict:
    want = dict.fromkeys(("density", "accel", "rebin", "contact",
                          "expand"), 0)
    if rung is None:
        return want
    kind, steps, sub, rebin_every = rung
    total = sub * (1 + max(1, steps // sub))
    if kind == "cells":
        want.update(contact=total, expand=total)
    else:
        rebins = sum(i % rebin_every == rebin_every - 1
                     for i in range(total))
        want.update(density=total, accel=total, rebin=2 * rebins)
    return want


def bench_phase(main_sps: float, card: str) -> None:
    """Phase 19: the port's bench, every rung, as a user runs it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "sph_tpu_torch.bench", "--all", "--cells",
           "--breakdown"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                       timeout=BENCH_TIMEOUT,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    say("bench", f"{' '.join(cmd[1:])}: exit {r.returncode} in {wall:.1f} s")
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: exit {r.returncode}, stdout "
                             f"{r.stdout[-2000:]!r}")
    out = json.loads(lines[0])
    detail = out["detail"]
    errors = {k: v["error"] for k, v in detail.items() if "error" in v}
    if errors or set(BENCH_RUNGS) - set(detail):
        raise AssertionError(f"bench: errors {errors}, rungs missing "
                             f"{sorted(set(BENCH_RUNGS) - set(detail))}")
    head = detail[BENCH_CONFIG3]
    if not (head["alive"] == head["n_particles"] == N_CONFIG3
            and head["dropped"] == 0):
        raise AssertionError(f"bench config[3]: {head}")
    for name, rung in BENCH_RUNGS.items():
        want = bench_launches(rung)
        if detail[name]["launches"] != want:
            raise AssertionError(f"bench {name}: launches "
                                 f"{detail[name]['launches']} != {want}")
        if "dense)" in name and detail[name]["cell_overflow"] != 0:
            raise AssertionError(f"bench {name}: {detail[name]}")
    dryrun = detail[BENCH_CONFIG4]["dryrun_8way"]
    device = f"{out['device']['name']}, {out['device']['power_limit']}"
    if not str(out.get("verify", "")).startswith("ok") or dryrun != "ok":
        raise AssertionError(f"bench: verify {out.get('verify')!r}, 8-way "
                             f"dryrun {dryrun!r}")
    if device != card:
        raise AssertionError(f"bench device {device!r} != {card!r}")
    ratio = head["steps_per_sec"] / main_sps
    if not 0.5 <= ratio <= 2.0:
        raise AssertionError(f"bench config[3] {head['steps_per_sec']} "
                             f"steps/s against the main phase's "
                             f"{main_sps:.2f}: x{ratio:.3f}")
    say("bench", f"value {out['value']} particle-steps/s (vs_baseline "
        f"{out['vs_baseline']}), verify {out['verify']}, 8-way dryrun "
        f"{dryrun} ({detail[BENCH_CONFIG4]['dryrun_8way_ranks']}); "
        f"config[3] x{ratio:.3f} of the main phase's {main_sps:.2f} "
        f"steps/s | {card}")
    for name, e in detail.items():
        if name.startswith("phase_breakdown"):
            say("bench", f"{name}: {json.dumps(e)} | {card}")
            continue
        median = e.get("steps_per_sec_median", "-")
        pmedian = e.get("particle_steps_per_sec_median", "-")
        say("bench", f"ladder {name}: {e['n_particles']} particles, "
            f"steps/s best {e['steps_per_sec']} median {median}, "
            f"particle-steps/s best {e['particle_steps_per_sec']} median "
            f"{pmedian}, launches {e['launches']} | {card}")


# -- 12. shard: the sharded paths (sph_tpu_torch/parallel) -------------------

# BASELINE's config[4] (bench.py:193-201 → _bench_dense, bench.py:57-70):
# dam_break_3d at 4M particles, k = 8, cell_factor 1.35, rebin every 6,
# kernels on; the bench's 45 steps in blocks of 15.
CONFIG4 = dict(n_target=4_000_000, cell_factor=1.35, dense_k=8,
               rebin_every=6, use_pallas=True)
N_CONFIG4 = 4_012_092
SHARD_STEPS, SHARD_SUBSTEPS, SHARD_MORE = 45, 15, 15
SHARD_RANKS = 4
# tests/test_dist.py's random fluid at 262,144 particles, 12 steps, with 8
# slots a cell: its ~0.77 particles a cell at cell_factor 1.3 put more
# than 4 in some of the 1.2M cells at this size.
STRESS_N, STRESS_STEPS, STRESS_K = 262_144, 12, 8
COLONY_SHARD_STEPS = 5
# tests/test_dist.py's division window: 256 cells resized to 320, 16
# timers armed to split within the 8 steps.
WINDOW_N, WINDOW_CAPACITY, WINDOW_ARMED, WINDOW_STEPS = 256, 320, 16, 8
NCCL_STEPS = 12
SHARD_TIMEOUT = 900.0
SHARD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "shard")
SHARED_CARD = "4 ranks sharing one card over gloo"


def random_fluid(n: int, k: int, seed: int = 0):
    """tests/test_dist.py's random fluid (numpy draws in its order) with k
    slots a cell: ~0.35 particles a cell at cell_factor 1, cell_factor
    1.3, rebin every 3, random velocities that carry particles across the
    ranks' seams; kernels on."""
    from sph_tpu_torch.sph.model import SPHParams, SPHState

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    h = float((0.15 * 0.729 / n) ** (1 / 3))
    params = SPHParams(
        ndim=3, h=h, particle_mass=1000.0 / n, bounds_min=(0.0, 0.0, 0.0),
        bounds_max=(1.0, 1.0, 1.0), dt=0.25 * h / 60.0, sound_speed=60.0,
        viscosity=0.05, dense_k=k, cell_factor=1.3, use_pallas=True,
        rebin_every=3)
    state = SPHState.from_positions(torch.from_numpy(pos), params)
    vel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    return dataclasses.replace(state, vel=torch.from_numpy(vel)), params


def save_reference(d, path: str) -> str:
    """Every field of a dense state as one .npy file each (read back by
    the ranks memory-mapped, a block at a time), counters as JSON."""
    from sph_tpu_torch.parallel.dist import FIELDS

    os.makedirs(path, exist_ok=True)
    for f in FIELDS:
        np.save(os.path.join(path, f"{f}.npy"), getattr(d, f).cpu().numpy())
    with open(os.path.join(path, "counters.json"), "w") as fh:
        json.dump({f: int(getattr(d, f)) for f in
                   ("dropped", "clamped", "step_count")}, fh)
    return path


def same_block(sim, ref: str) -> dict:
    """This rank's block of a FluidSimulation (the whole state without a
    mesh) against the same cells of a reference saved by save_reference:
    the slots that differ per field (−0 == +0, as K3 and the plain rebin
    are held to each other), whether the padding past the global layout
    still holds its fills, the counters, and the block's particles."""
    from sph_tpu_torch.parallel.dist import FIELDS, _pad_fill, blocks

    d, spec = sim.dstate, sim.spec
    shape = (1,) if sim.mesh is None else sim.mesh.shape
    coords = (0,) if sim.mesh is None else sim.mesh.coords
    planes, rows = blocks(spec, shape)
    z0 = coords[0] * planes
    c0 = coords[1] * rows * spec.X if len(shape) == 2 else 0
    nz = min(planes, spec.n0 - z0)
    nc = min(d.px.shape[2], spec.C - c0)
    fills = _pad_fill(sim.params)
    differ, pads = {}, True
    for f in FIELDS:
        want = np.load(os.path.join(ref, f"{f}.npy"), mmap_mode="r")
        want = torch.from_numpy(np.array(
            want[z0:z0 + nz, :, c0:c0 + nc])).to(d.px.device)
        got = getattr(d, f)
        n = int((got[:nz, :, :nc] != want).sum())
        if n:
            differ[f] = {"slots": n, "max_abs_err": float(
                (got[:nz, :, :nc] - want).abs().max())}
        pads &= bool((got[nz:] == fills[f]).all()
                     and (got[:, :, nc:] == fills[f]).all())
    with open(os.path.join(ref, "counters.json")) as fh:
        want_counters = json.load(fh)
    counters = {f: int(getattr(d, f)) for f in want_counters}
    return {"differ": differ, "pads": pads, "counters": counters,
            "want_counters": want_counters,
            "particles": int(d.occ[:nz, :, :nc].sum())}


def fluid_on_mesh(mesh, job: dict, name: str) -> dict:
    """config[4] through FluidSimulation on `mesh`: 45 steps, counters
    reset just before; its block against the single-device run. On the
    ring also the checkpoints: saved on the ring after 45 steps, the ring
    stepped 15 more; that checkpoint loaded on one device (rank 0) and
    the single-device checkpoint loaded on the ring, each stepped 15."""
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    sim = FluidSimulation.from_scene("dam_break_3d", mesh=mesh,
                                     substeps=SHARD_SUBSTEPS, **job["scene"])
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mesh.reset_stats()
    reset_launches()
    sps = sim.run(job["steps"])
    out = {"setup_s": setup_s, "sps": sps, "launches": dict(LAUNCHES),
           "stats": dict(mesh.stats), "block": list(sim.dstate.px.shape),
           "same": same_block(sim, job["ref"])}
    if name != "ring":
        return out
    ckpt = os.path.join(job["dir"], "ring.npz")
    sim.save(ckpt)
    sim.run(job["more"])
    out["same_more"] = same_block(sim, job["ref_more"])
    del sim
    if mesh.rank == 0:
        one = FluidSimulation.load(ckpt, device=mesh.device)
        one.run(job["more"])
        out["one_from_ring"] = same_block(one, job["ref_more"])
        del one
    mesh.barrier()
    ring = FluidSimulation.load(job["ckpt"], mesh=mesh)
    ring.run(job["more"])
    out["ring_from_one"] = same_block(ring, job["ref_more"])
    return out


def stress_on_mesh(mesh, job: dict) -> dict:
    """The random fluid on `mesh`: the block's particles before and after,
    and the block against the single-device run."""
    from sph_tpu_torch.engine.fluid import FluidSimulation

    state, params = random_fluid(job["n"], job["k"])
    sim = FluidSimulation(state, params, substeps=job["steps"], mesh=mesh)
    before = int(sim.dstate.occ.sum())
    sim.run(job["steps"])
    return {"before": before, "after": int(sim.dstate.occ.sum()),
            "same": same_block(sim, job["ref"])}


def colony_on_mesh(mesh, job: dict) -> dict:
    """Simulation.load(checkpoint, mesh=…) stepped `steps` steps, counters
    reset just before: the launches, a digest of the whole state (equal on
    every rank) and, on rank 0, the fields that differ from the
    single-device run."""
    import hashlib

    from sph_tpu_torch.core.types import state_to_numpy
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches

    sim = Simulation.load(job["ckpt"], mesh=mesh)
    torch.cuda.synchronize()
    mesh.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    sim.step(job["steps"])
    torch.cuda.synchronize()
    out = {"sps": job["steps"] / (time.perf_counter() - t0),
           "launches": dict(LAUNCHES), "stats": dict(mesh.stats),
           "active": int(sim.state.active_count)}
    flat = state_to_numpy(sim.state)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode() + np.ascontiguousarray(flat[k]).tobytes())
    out["digest"] = h.hexdigest()
    if mesh.rank == 0:
        with np.load(job["ref"]) as ref:
            out["differ"] = [k for k in ref.files
                             if not np.array_equal(ref[k], flat[k])]
    return out


def shard_rank(job: dict) -> dict:
    """One rank of the shard phase's world: config[4] on a 4-ring and on a
    2×2 mesh, the migration stress on the ring, the 1M colony and the
    division window on both meshes."""
    from sph_tpu_torch.parallel.dist import make_mesh_2d, make_multislice_mesh

    meshes = {"ring": make_multislice_mesh(device=job["device"]),
              "2x2": make_mesh_2d((2, 2), axis_names=("z", "y"),
                                  device=job["device"])}
    out = {"backend": meshes["ring"].backend,
           "device": str(meshes["ring"].device)}
    for name, mesh in meshes.items():
        out[f"config4_{name}"] = fluid_on_mesh(mesh, job["config4"], name)
    out["stress"] = stress_on_mesh(meshes["ring"], job["stress"])
    for case in ("colony", "window"):
        for name, mesh in meshes.items():
            out[f"{case}_{name}"] = colony_on_mesh(mesh, job[case])
    return out


def nccl_rank(job: dict) -> dict:
    """The one rank of an nccl world: config[3] through FluidSimulation on
    a ring of one rank, counters reset just before."""
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.parallel.dist import make_multislice_mesh

    mesh = make_multislice_mesh(device=job["device"])
    sim = FluidSimulation.from_scene("dam_break_3d_obstacle", mesh=mesh,
                                     substeps=6, **job["scene"])
    torch.cuda.synchronize()
    reset_launches()
    sps = sim.run(job["steps"])
    return {"backend": mesh.backend, "sps": sps, "launches": dict(LAUNCHES),
            "same": same_block(sim, job["ref"])}


def failing_rank() -> None:
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


def exact_same(where: str, r: dict, counters: bool = True) -> None:
    """A block (or state) must equal the single-device run's in every
    field, keep its padding, and (unless told) match its counters."""
    if r["differ"] or not r["pads"]:
        raise AssertionError(f"{where}: differs from one device: {r}")
    if counters and r["counters"] != r["want_counters"]:
        raise AssertionError(f"{where}: counters {r['counters']} != "
                             f"{r['want_counters']}")


def slab_kernels(d, p, spec, colony, card) -> None:
    """K1 and K2 on config[4]'s halo-padded blocks (ring rank 0; rank
    (0, 1) of the 2×2 mesh, whose rows take the y halo) and K4 on the 1M
    colony's (ring rank 1; 2×2 rank (1, 0)), each bitwise to its plain
    version and timed against it, beside its bound: one line of times
    and counts each."""
    from sph_tpu_torch.parallel.dist import contact_block, fluid_slab
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import (
        accel_inputs,
        check_accel,
        check_contact_fields,
        check_density,
        compressed,
    )

    rows = []
    for shape, coords in (((SHARD_RANKS,), (0,)), ((2, 2), (0, 1))):
        slab, sspec = fluid_slab(d, p, spec, shape, coords)
        checks = {"density": check_density(slab, p, sspec),
                  "accel": check_accel(accel_inputs(slab, p, sspec), p,
                                       sspec)}
        where = f"config[4] block {coords} of {shape}"
        exact_sweeps(where, checks)
        n_pairs, n_near, n_occ = fluid_pairs(slab, sspec)
        for name, (kern, plain, _, bnd) in sweep_time_pairs(
                slab, p, sspec, n_pairs, n_near).items():
            ms, plain_ms, runs = turns(kern, plain)
            rows.append({"kernel": name, "where": where,
                         "shape": list(slab.px.shape), "ms": ms,
                         "plain_ms": plain_ms, "turns_pkkp_ms": runs, **bnd,
                         "occupied": n_occ, "pairs": n_pairs})
    st, cp, cspec = colony["sim"].state, colony["sim"].params, colony["spec"]
    fields, occ, _, _ = cd._pack_args(st, cspec, expand=True)
    squeezed = cd._pack_args(compressed(st, 0.7), cspec, expand=True)[:2]
    for shape, coords in (((SHARD_RANKS,), (1,)), ((2, 2), (1, 0))):
        where = f"1M colony block {coords} of {shape}"
        # Bitwise on the compressed copy too, where contacts occur.
        block, sspec = contact_block([*squeezed[0], squeezed[1]], cspec,
                                     shape, coords)
        r = check_contact_fields(block[:10], block[10], cp, sspec)
        exact_contact(f"{where}, compressed x0.7", r)
        if r["contact_slots"] == 0:
            raise AssertionError(f"{where}: no contact in the compressed "
                                 f"block")
        block, sspec = contact_block([*fields, occ], cspec, shape, coords)
        f_s, occ_s = block[:10], block[10]
        exact_contact(where, check_contact_fields(f_s, occ_s, cp, sspec))
        w, (kern, plain, _, bnd) = contact_pair(f_s, occ_s, cp, sspec)
        ms, plain_ms, runs = turns(kern, plain)
        rows.append({"kernel": "contact", "where": where,
                     "shape": list(occ_s.shape), "ms": ms,
                     "plain_ms": plain_ms, "turns_pkkp_ms": runs, **bnd,
                     **w})
    for r in rows:
        say("shard", f"{r['kernel']} at {r['where']}, bitwise: "
            f"{json.dumps(r)} | {card}")


def shard_phase(colony, dev, card) -> None:
    """Phase 12: config[4] on one device, then on 4 ranks sharing the
    card over gloo (a 4-ring and a 2×2 mesh), the migration stress, the
    1M colony and the division window on both meshes, checkpoints across
    meshes both ways; a one-rank nccl world at config[3]; a rank that
    raises fails its world. Every sharded run is held bitwise to the
    single-device run; K1, K2, K4 and K5 must launch on every rank, K3
    (the sharded rebin is the plain one) never."""
    import shutil

    from sph_tpu_torch.core.types import state_to_numpy
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.fluid import FluidSimulation
    from sph_tpu_torch.engine.simulation import Simulation
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.parallel.launch import spawn

    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)

    def path(name):
        return os.path.join(SHARD_DIR, name)

    # config[4] on one device: the reference of every sharded fluid run.
    t0 = time.perf_counter()
    one = FluidSimulation.from_scene("dam_break_3d", substeps=SHARD_SUBSTEPS,
                                     device=dev, **CONFIG4)
    d, spec = one.dstate, one.spec
    occupied = float(d.occ.sum()) / d.occ.numel()
    say("shard", f"config[4] packed: layout {list(d.px.shape)} "
        f"({d.px.numel() * 4 / 1e6:.1f} MB a field, {occupied:.1%} of slots "
        f"occupied), {time.perf_counter() - t0:.1f} s")
    reset_launches()
    sps = one.run(SHARD_STEPS)
    launches = dict(LAUNCHES)
    m = check_state(one, N_CONFIG4)
    want = {"density": SHARD_STEPS, "accel": SHARD_STEPS,
            "rebin": 2 * (SHARD_STEPS // CONFIG4["rebin_every"]),
            "contact": 0, "expand": 0}
    if launches != want:
        raise AssertionError(f"config[4] launches {launches} != {want}")
    say("shard", f"config[4] one device, {SHARD_STEPS} steps: {sps:.2f} "
        f"steps/s, {sps * N_CONFIG4:.4g} particle-steps/s, dropped "
        f"{m['dropped']}, clamped {m['clamped']}, launches {launches} | "
        f"{card}")
    slab_kernels(one.dstate, one.params, spec, colony, card)
    ref = save_reference(one.dstate, path("config4"))
    one.save(path("one.npz"))
    one.run(SHARD_MORE)
    ref_more = save_reference(one.dstate, path("config4_more"))
    del one, d

    state, params = random_fluid(STRESS_N, STRESS_K)
    stress = FluidSimulation(state, params, substeps=STRESS_STEPS,
                             device=dev)
    stress.run(STRESS_STEPS)
    ref_stress = save_reference(stress.dstate, path("stress"))
    say("shard", f"migration stress: {STRESS_N} particles, layout "
        f"{list(stress.dstate.px.shape)}, {STRESS_STEPS} steps on one device")
    del stress

    colony["sim"].save(path("colony.npz"))
    sim = Simulation.load(path("colony.npz"), device=dev)
    sim.step(COLONY_SHARD_STEPS)
    np.savez(path("colony_ref.npz"), **state_to_numpy(sim.state))
    del sim
    wstate, wparams, wgenome = bonded_colony(
        WINDOW_N, neighbor_mode="dense", dense_k=2, use_pallas=True,
        max_splits_per_step=32, device=dev)
    sim = Simulation(wgenome, wparams, device=dev)
    sim.state = wstate
    sim.resize(WINDOW_CAPACITY)
    timer = sim.state.split_timer.clone()
    timer[:WINDOW_ARMED] = (wgenome.modes[0].split_interval
                            - 2 * wparams.dt)
    sim.state = sim.state.replace_fields(split_timer=timer)
    sim.save(path("window.npz"))
    sim = Simulation.load(path("window.npz"), device=dev)
    sim.step(WINDOW_STEPS)
    if int(sim.state.active_count) != WINDOW_N + WINDOW_ARMED:
        raise AssertionError(f"division window: {int(sim.state.active_count)}"
                             f" cells, want {WINDOW_N + WINDOW_ARMED}")
    np.savez(path("window_ref.npz"), **state_to_numpy(sim.state))
    del sim
    torch.cuda.empty_cache()

    job = {
        "device": "cuda",
        "config4": {"scene": CONFIG4, "steps": SHARD_STEPS,
                    "more": SHARD_MORE, "ref": ref, "ref_more": ref_more,
                    "ckpt": path("one.npz"), "dir": SHARD_DIR},
        "stress": {"n": STRESS_N, "k": STRESS_K, "steps": STRESS_STEPS,
                   "ref": ref_stress},
        "colony": {"ckpt": path("colony.npz"), "ref": path("colony_ref.npz"),
                   "steps": COLONY_SHARD_STEPS},
        "window": {"ckpt": path("window.npz"), "ref": path("window_ref.npz"),
                   "steps": WINDOW_STEPS},
    }
    t0 = time.perf_counter()
    ranks = spawn(shard_rank, SHARD_RANKS, "gloo", "cuda", path("init"),
                  args=(job,), timeout=SHARD_TIMEOUT)
    say("shard", f"world of {SHARD_RANKS} ranks, backend "
        f"{ranks[0]['backend']}, devices "
        f"{sorted({r['device'] for r in ranks})}: "
        f"{time.perf_counter() - t0:.1f} s")
    shard_report(ranks, card)

    # A one-rank nccl world at config[3] (the nccl path: its collectives;
    # a ring of one rank exchanges with itself).
    one = FluidSimulation.from_scene("dam_break_3d_obstacle", substeps=6,
                                     device=dev, **CONFIG3)
    one.run(NCCL_STEPS)
    ref3 = save_reference(one.dstate, path("config3"))
    del one
    r = spawn(nccl_rank, 1, "nccl", "cuda", path("init_nccl"),
              args=({"device": "cuda", "scene": CONFIG3, "steps": NCCL_STEPS,
                     "ref": ref3},), timeout=SHARD_TIMEOUT)[0]
    exact_same("nccl config[3]", r["same"])
    want = {"density": NCCL_STEPS, "accel": NCCL_STEPS, "rebin": 0,
            "contact": 0, "expand": 0}
    if r["backend"] != "nccl" or r["launches"] != want:
        raise AssertionError(f"nccl world: {r['backend']} {r['launches']}")
    say("shard", f"config[3] on a one-rank nccl world, {NCCL_STEPS} steps: "
        f"{r['sps']:.2f} steps/s, launches {r['launches']}, bitwise to "
        f"one device | {card}")

    try:
        spawn(failing_rank, 2, "gloo", "cuda", path("init_fail"),
              timeout=120.0)
    except RuntimeError as e:
        if "rank 1 of 2 failed" not in str(e):
            raise
        say("shard", "a rank that raises fails its world: spawn raised "
            "RuntimeError('rank 1 of 2 failed')")
    else:
        raise AssertionError("a failing rank did not fail its world")
    shutil.rmtree(SHARD_DIR, ignore_errors=True)


def shard_report(ranks, card) -> None:
    """Checks and prints the results of the shard world's ranks."""
    for name in ("ring", "2x2"):
        rs = [r[f"config4_{name}"] for r in ranks]
        for i, r in enumerate(rs):
            exact_same(f"config[4] {name} rank {i}", r["same"])
            want = {"density": SHARD_STEPS, "accel": SHARD_STEPS,
                    "rebin": 0, "contact": 0, "expand": 0}
            if r["launches"] != want:
                raise AssertionError(f"config[4] {name} rank {i} launches "
                                     f"{r['launches']} != {want}")
        total = sum(r["same"]["particles"] for r in rs)
        if total != N_CONFIG4:
            raise AssertionError(f"config[4] {name}: {total} particles")
        sps = [r["sps"] for r in rs]
        st = rs[0]["stats"]
        say("shard", f"config[4] on the {name} mesh ({SHARED_CARD}), "
            f"blocks {[r['block'] for r in rs]}, {SHARD_STEPS} steps: "
            f"{min(sps):.2f}–{max(sps):.2f} steps/s over ranks, rank 0 "
            f"halo {st['halo_bytes'] / SHARD_STEPS / 1e6:.3f} MB a step, "
            f"staged {st['staged_bytes'] / SHARD_STEPS / 1e6:.3f} MB a step,"
            f" host staging {st['staging_s'] * 1e3 / SHARD_STEPS:.3f} ms a "
            f"step, {st['messages']} messages; launches a rank "
            f"{rs[0]['launches']}; particles a block "
            f"{[r['same']['particles'] for r in rs]}; counters "
            f"{rs[0]['same']['counters']}; bitwise to one device | {card}")
    ring = [r["config4_ring"] for r in ranks]
    for i, r in enumerate(ring):
        exact_same(f"ring after more steps, rank {i}", r["same_more"],
                   counters=False)
        exact_same(f"ring from one device's checkpoint, rank {i}",
                   r["ring_from_one"], counters=False)
    exact_same("one device from the ring's checkpoint",
               ring[0]["one_from_ring"], counters=False)
    say("shard", f"checkpoints: saved on the ring, loaded on one device; "
        f"saved on one device, loaded on the ring; each {SHARD_MORE} more "
        f"steps bitwise to one device (counters "
        f"{ring[0]['one_from_ring']['counters']} vs "
        f"{ring[0]['one_from_ring']['want_counters']})")

    stress = [r["stress"] for r in ranks]
    for i, r in enumerate(stress):
        exact_same(f"stress rank {i}", r["same"], counters=False)
    before = sum(r["before"] for r in stress)
    after = sum(r["after"] for r in stress)
    crossed = sum(abs(r["after"] - r["before"]) for r in stress) // 2
    if before != after or before != STRESS_N or crossed == 0:
        raise AssertionError(f"stress: {before} -> {after}, crossed "
                             f"{crossed}")
    say("shard", f"migration stress ({STRESS_N} particles, {STRESS_STEPS} "
        f"steps on the ring): population {before} -> {after}, at least "
        f"{crossed} particles crossed a seam (blocks "
        f"{[r['before'] for r in stress]} -> "
        f"{[r['after'] for r in stress]}), counters "
        f"{stress[0]['same']['counters']} (one device "
        f"{stress[0]['same']['want_counters']}), bitwise")

    for case, steps in (("colony", COLONY_SHARD_STEPS),
                        ("window", WINDOW_STEPS)):
        for name in ("ring", "2x2"):
            rs = [r[f"{case}_{name}"] for r in ranks]
            if len({r["digest"] for r in rs}) != 1 or rs[0]["differ"]:
                raise AssertionError(f"{case} {name}: ranks differ or "
                                     f"differ from one device: "
                                     f"{rs[0]['differ']}")
            want = {"density": 0, "accel": 0, "rebin": 0,
                    "contact": steps, "expand": steps}
            for i, r in enumerate(rs):
                if r["launches"] != want:
                    raise AssertionError(f"{case} {name} rank {i} launches "
                                         f"{r['launches']} != {want}")
            st = rs[0]["stats"]
            say("shard", f"{case} on the {name} mesh ({SHARED_CARD}), "
                f"{steps} steps: {min(r['sps'] for r in rs):.2f} steps/s "
                f"(slowest rank), {rs[0]['active']} cells, rank 0 halo "
                f"{st['halo_bytes'] / steps / 1e6:.3f} MB and staged "
                f"{st['staged_bytes'] / steps / 1e6:.3f} MB a step, "
                f"launches a rank {rs[0]['launches']}; every rank bitwise "
                f"to one device | {card}")

if __name__ == "__main__":
    sys.exit(main())
