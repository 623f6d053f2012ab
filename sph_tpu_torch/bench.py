"""Benchmark harness of the port: the counterpart of the repository's
`bench.py`, with its flags, rungs, settings and JSON line; each dense
rung runs its config's layout (`scenes.LAYOUTS`; config[3]'s has 16 slots,
not the JAX bench's 8, at which the rebin drops particles).

    python -m sph_tpu_torch.bench                 # config[3] on the card
    python -m sph_tpu_torch.bench --all --cells --breakdown
    python -m sph_tpu_torch.bench --device cpu    # plain versions, tiny runs only

Stdout carries ONE JSON line: `metric`, `value` (particle-steps/s of the
head rung, config[3]), `unit`, `vs_baseline` (the fraction of the north
star's 60M particle-steps/s: 1M particles at 60 steps/s), `detail` (one
entry per rung under the JAX bench's names and keys), `device` (the
card's name and power limit as nvidia-smi prints them; "cpu" on the
CPU) and, unless --no-verify, `verify` (the hardware verification lane,
utils/verify.py). Each rung's entry also carries `launches`: the kernel
launches (`ops.LAUNCHES`) of its warm and timed steps. Progress lines go
to stderr.

Timing windows are the JAX bench's: one warm call, then `steps //
substeps` timed calls of `substeps` steps, each ending in a device
synchronise and the read of a small reduction; steps/s best and median.
The rebin cadence runs on the host's step mirror (`make_dense_step`), so
no window waits for the device mid-call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

import torch

from sph_tpu_torch.ops import LAUNCHES, reset_launches
from sph_tpu_torch.sph.scenes import LAYOUTS

_T0 = time.monotonic()
UNIT = "particle-steps/sec"
# The north star: 1M particles at 60 steps/s (BASELINE.json).
BASELINE = 60e6
OBSTACLE = (("cylinder_z", (1.2, 0.15), 0.12),)


def _note(msg: str) -> None:
    """Flushed stderr progress line (stdout stays the single JSON line)."""
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _rate_stats(rates: list[float], n: int) -> dict:
    """Best AND median steps/s over the timing windows."""
    best = max(rates)
    med = statistics.median(rates)
    return {
        "steps_per_sec": round(best, 2),
        "steps_per_sec_median": round(med, 2),
        "n_particles": n,
        "particle_steps_per_sec": round(best * n, 0),
        "particle_steps_per_sec_median": round(med * n, 0),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_dense(state, params, spec, steps: int, substeps: int,
                device: torch.device) -> dict:
    """The dense rungs' window: pack, one warm call of `substeps` steps,
    then `steps // substeps` timed calls, each ending in a synchronise and
    the read of (occupied slots, dropped, clamped)."""
    from sph_tpu_torch.sph.dense import make_dense_step, pack

    n = state.pos.shape[0]
    d = pack(state, params, spec, device=device)
    f = make_dense_step(params, spec, substeps=substeps)

    def red(d):
        _sync(device)
        return [float(x) for x in (d.occ.sum(), d.dropped, d.clamped)]

    reset_launches()
    d = f(d, 0)
    step = substeps
    red(d)
    rates = []
    for _ in range(max(1, steps // substeps)):
        t0 = time.perf_counter()
        d = f(d, step)
        step += substeps
        red(d)
        rates.append(substeps / (time.perf_counter() - t0))
    launches = dict(LAUNCHES)
    n_alive, dropped, clamped = red(d)
    out = _rate_stats(rates, n)
    out.update(alive=int(n_alive), dropped=int(dropped),
               clamped=int(clamped), launches=launches)
    return out


def _dense_scene(n_target: int, obstacles=(), **layout):
    """Config[2]-[4]'s 3D dam break with the kernels on, at config[2]'s
    layout unless `layout` names other keys: (state, params, spec)."""
    from sph_tpu_torch.sph.dense import make_dense_spec
    from sph_tpu_torch.sph.scenes import dam_break_3d

    state, params = dam_break_3d(n_target=n_target, obstacles=obstacles,
                                 use_pallas=True, **{**LAYOUTS[2], **layout})
    return state, params, make_dense_spec(params, k=params.dense_k,
                                          cell_factor=params.cell_factor)


def _bench_dense(n_target: int, steps: int = 240, substeps: int = 60,
                 obstacles=(), device="cuda", **layout):
    """Config[2]-[4]: a 3D dam break on the dense grid through K1-K3, at
    config[2]'s layout unless `layout` names other keys."""
    return _time_dense(*_dense_scene(n_target, obstacles, **layout), steps,
                       substeps, torch.device(device))


def _bench_2d_bruteforce(n_target: int, steps: int = 20, device="cuda"):
    """Config[0]: the sort+gather grid path (sph/model.py's sph_step),
    which launches no kernel: one warm call of `steps` steps, one timed."""
    from sph_tpu_torch.sph.model import make_sph_step
    from sph_tpu_torch.sph.scenes import dam_break_2d

    device = torch.device(device)
    state, params = dam_break_2d(n_target=n_target)
    n = state.pos.shape[0]
    f = make_sph_step(params, substeps=steps, device=device)
    reset_launches()
    state = f(state)
    float(state.pos.sum())
    t0 = time.perf_counter()
    state = f(state)
    float(state.pos.sum())
    sps = steps / (time.perf_counter() - t0)
    return {"steps_per_sec": round(sps, 2), "n_particles": n,
            "particle_steps_per_sec": round(sps * n, 0),
            "launches": dict(LAUNCHES)}


def _bench_2d_dense(n_target: int, steps: int = 480, substeps: int = 120,
                    device="cuda"):
    """Config[1]: 2D splash/pour on the dense grid through K1-K3."""
    from sph_tpu_torch.sph.dense import make_dense_spec
    from sph_tpu_torch.sph.scenes import splash_pour_2d

    state, params = splash_pour_2d(n_target=n_target, use_pallas=True,
                                   **LAYOUTS[1])
    spec = make_dense_spec(params, k=params.dense_k,
                           cell_factor=params.cell_factor)
    return _time_dense(state, params, spec, steps, substeps,
                       torch.device(device))


def _bench_cells(n: int, steps: int = 240, chunk: int = 120,
                 neighbor_mode: str = "dense", device="cuda"):
    """The biology/contact regime: a settled bonded colony (contact,
    rotation, adhesion, bond pruning, division bookkeeping) stepped through
    Simulation in chunks of `chunk` steps. 'dense' runs the contact pack
    (K5) and sweep (K4), and from 163,840 bond rows the planned adhesion;
    'grid' the sort+gather engine, no kernel."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.simulation import Simulation

    device = torch.device(device)
    state, params, genome = bonded_colony(
        n, neighbor_mode=neighbor_mode,
        grid_dim=48, grid_cell_size=4.0, cell_capacity=16,
        max_splits_per_step=64,
        dense_k=2, use_pallas=(neighbor_mode == "dense"), device=device,
    )
    sim = Simulation(genome, params, auto_grow=False, scan_chunk=chunk,
                     device=device)
    sim.state = state

    def sync():
        _sync(device)
        return float(sim.state.pos[0].sum())

    reset_launches()
    sim.step(chunk)
    sync()
    rates = []
    for _ in range(max(1, steps // chunk)):
        t0 = time.perf_counter()
        sim.step(chunk)
        sync()
        rates.append(chunk / (time.perf_counter() - t0))
    launches = dict(LAUNCHES)
    out = _rate_stats(rates, n)
    out.update(
        neighbor_mode=neighbor_mode,
        bonds=int(sim.state.bonds.active.sum()),
        cell_overflow=int(sim.state.overflow),
        backend=device.type,
        launches=launches,
    )
    return out


def _bench_4m_multichip(device="cuda"):
    """Config[4]: the 4M+ dam break on one device, then the 8-way sharded
    dryrun (parallel/dryrun.py): 8 gloo ranks on the visible cards (more
    ranks than cards share them), each check bitwise to one device — a
    correctness dryrun, not a multi-GPU speed."""
    from sph_tpu_torch.parallel.dryrun import dryrun_multichip

    device = torch.device(device)
    out = _bench_dense(4_000_000, steps=45, substeps=15, device=device,
                       **LAYOUTS[4])
    _note("4M dense done; starting 8-way decomposition dryrun")
    where = ("the CPU" if device.type == "cpu"
             else f"{torch.cuda.device_count()} card(s)")
    try:
        dryrun_multichip(8, device=device.type)
        out["dryrun_8way"] = "ok"
    except Exception as e:  # noqa: BLE001 — recorded in the JSON line
        _note(traceback.format_exc())
        out["dryrun_8way"] = f"FAIL {type(e).__name__}: {str(e)[:200]}"
    out["dryrun_8way_ranks"] = (f"8 gloo ranks on {where}: a correctness "
                                "dryrun, not a multi-GPU speed")
    _note(f"8-way dryrun: {out['dryrun_8way']}")
    return out


CONFIGS = {
    0: ("2D dam-break 4k (brute-force executable spec)",
        lambda device: _bench_2d_bruteforce(4096, device=device)),
    1: ("2D splash/pour 32k (dense grid + Pallas)",
        lambda device: _bench_2d_dense(32768, device=device)),
    2: ("3D dam-break 256k (dense grid + Pallas)",
        lambda device: _bench_dense(262144, device=device)),
    3: ("3D dam-break + SDF obstacle 1M (dense grid + Pallas)",
        lambda device: _bench_dense(1_000_000, obstacles=OBSTACLE,
                                    device=device, **LAYOUTS[3])),
    4: ("3D dam-break 4M single-chip + 8-way decomposition dryrun",
        _bench_4m_multichip),
}
# --cells: (cells, neighbour mode, steps, chunk).
CELLS = (
    (10_240, "grid", 240, 120), (10_240, "dense", 240, 120),
    (102_400, "dense", 240, 120),
    # 100x the reference's 10k default capacity; scale row, short run.
    (1_048_576, "dense", 40, 20),
)
# --breakdown: the config[2] and config[3] rungs' scenes (`_dense_scene`).
BREAKDOWN = {
    "phase_breakdown_256k": dict(n_target=262144),
    "phase_breakdown_1m": dict(n_target=1_000_000, obstacles=OBSTACLE,
                               **LAYOUTS[3]),
}


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first card); on
    the CPU the name "cpu"."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, power = r.stdout.strip().splitlines()[0].rsplit(", ", 1)
    return {"name": name, "power_limit": power}


def _error_line(error: str, device: dict) -> None:
    """The contract line of a run that could not start."""
    print(json.dumps({
        "metric": f"{UNIT} (backend init)", "value": 0.0, "unit": UNIT,
        "vs_baseline": 0.0, "error": error, "device": device,
    }), flush=True)


def _backend_watchdog(device: torch.device, timeout_s: float = 300.0) -> None:
    """Fail fast if the card never comes up: if CUDA's initialisation and a
    first allocation do not return within `timeout_s`, print the contract
    line with an `error` field and exit 3."""
    done = threading.Event()

    def bail():
        if not done.wait(timeout_s):
            _error_line(f"CUDA init timed out after {timeout_s:.0f}s",
                        {"name": str(device), "power_limit": None})
            os._exit(3)

    threading.Thread(target=bail, daemon=True).start()
    torch.cuda.init()
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    done.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.bench")
    ap.add_argument("--config", type=int, default=3,
                    choices=sorted(CONFIGS), help="ladder rung to run")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--breakdown", action="store_true",
                    help="also report per-phase ms (grid build vs force sum)")
    ap.add_argument("--verify", action="store_true", default=True,
                    help="hold every kernel to its plain version on this "
                         "device and include the result in the JSON line "
                         "(default ON; --no-verify to skip)")
    ap.add_argument("--no-verify", dest="verify", action="store_false")
    ap.add_argument("--cells", action="store_true",
                    help="also bench the biology/contact regime: bonded "
                         "settled colonies at 10k (grid + dense engines), "
                         "100k and 1M (dense)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' "
                         "wrappers run their plain versions: tiny runs only")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            _error_line("no CUDA device is visible (--device cpu runs the "
                        "plain versions)", {"name": None, "power_limit": None})
            return 1
        _backend_watchdog(device)
        from sph_tpu_torch.ops.build import library

        lib = library()
        _note(f"kernels ready: {lib.path.name} (built in {lib.seconds:.1f} s)")
    card = device_info(device)

    if args.all:
        detail = {}
        for idx, (name, fn) in CONFIGS.items():
            _note(f"config[{idx}] start: {name}")
            try:
                detail[name] = fn(device)
                _note(f"config[{idx}] done: "
                      f"{detail[name].get('steps_per_sec')} steps/s")
            except Exception as e:  # noqa: BLE001 — recorded in the line
                _note(traceback.format_exc())
                detail[name] = {"error": str(e)[:200]}
                _note(f"config[{idx}] ERROR: {str(e)[:200]}")
        head_name = CONFIGS[3][0]
        head = detail[head_name]
    else:
        head_name, fn = CONFIGS[args.config]
        _note(f"config[{args.config}] start: {head_name}")
        head = fn(device)
        detail = {head_name: head}

    if args.cells:
        for n, mode, steps, chunk in CELLS:
            size = f"{n // 1024}k" if n < 1 << 20 else f"{n / (1 << 20):g}M"
            key = f"cell colony {size} (contact+adhesion, {mode})"
            _note(f"cells start: {key}")
            try:
                detail[key] = _bench_cells(n, steps=steps, chunk=chunk,
                                           neighbor_mode=mode, device=device)
                _note(f"cells done: {key} = "
                      f"{detail[key].get('steps_per_sec')} steps/s")
            except Exception as e:  # noqa: BLE001 — recorded in the line
                _note(traceback.format_exc())
                detail[key] = {"error": str(e)[:200]}
                _note(f"cells ERROR: {key}: {str(e)[:200]}")

    if args.breakdown:
        _note("breakdown start (256k + 1M phase splits)")
        from sph_tpu_torch.sph.dense import pack
        from sph_tpu_torch.utils.profiling import step_breakdown

        # The config[2] and config[3] rungs' settings, so each split
        # explains its rung's rate.
        for key, kw in BREAKDOWN.items():
            st, prm, spc = _dense_scene(**kw)
            detail[key] = step_breakdown(pack(st, prm, spc, device=device),
                                         prm, spc)

    value = head.get("particle_steps_per_sec", 0.0)
    out = {
        "metric": f"{UNIT} ({head_name}, 1 chip)",
        "value": value,
        "unit": UNIT,
        "vs_baseline": round(value / BASELINE, 4),
        "detail": detail,
        "device": card,
    }
    if args.verify:
        from sph_tpu_torch.utils.verify import verify_summary

        _note("verify start")
        out["verify"] = verify_summary(device)
        _note(f"verify: {out['verify']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
