"""The benchmark's one command:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from BENCHMARK.json, builds its seeded inputs, hands them
to the program (sph_tpu_torch) through its public API, warms up the
cell's own shapes, measures whole frames until their time reaches
--seconds, checks the frames drawn from the seed against the plain
reference, and prints one JSON line last on stdout:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read from a torch.profiler trace of
`traced_frames` frames after the window's first three (written under
build/benchmark/<cell>/trace.json). Progress goes to stderr, and its last lines are the compared
numbers beside their limits. Exits non-zero, with no result, where no
card is visible or the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark.harness import device, spec, trace  # noqa: E402
from benchmark.harness.frames import no_span  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def guard(stage: str) -> None:
    bad = device.forbidden_modules()
    if bad:
        raise SystemExit(f"{stage}: the process holds {', '.join(bad)}; "
                         "the benchmark measures the PyTorch port alone")


def run_cell(cell, seed: int, seconds: float, traced: bool, dev="cuda",
             t0: float = T0, control: bool = False, out=log,
             trace_dir=None) -> dict:
    """One run of `cell`; returns the result's fields. `control` replaces
    the program's output by the reference's in bfloat16 in the checks.
    The trace goes to trace_dir (default build/benchmark/<cell>/)."""
    import torch

    driver = spec.module("drivers", cell.traffic["driver"]).Driver(
        cell, seed, dev, out)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out(f"set-up: imports and card initialisation "
        f"{time.perf_counter() - t0:.3f} s")
    driver.setup()
    guard("after set-up")
    setup_s = time.perf_counter() - t0
    if dev == "cuda":
        from sph_tpu_torch.ops import LAUNCHES
        from sph_tpu_torch.ops.build import library

        lib = library()
        out(f"kernel library: {lib.path.name}, "
            + (f"built in {lib.seconds:.3f} s" if lib.seconds
               else "loaded from cache"))
        out(f"card: {device.card_state()}")
        launches0 = dict(LAUNCHES)
    out(f"set-up {setup_s:.3f} s; checks at frames "
        f"{sorted(driver.check_frames)}")

    n_traced = int(cell.traffic["traced_frames"]) if traced else 0
    trace_path = (spec.ROOT / "build" / "benchmark" / cell.name
                  if trace_dir is None else trace_dir) / "trace.json"
    prof = None
    span = no_span
    if traced:
        # The first PROFILER_WARMUP frames run under the profiler and are
        # discarded (its start-up cost lands there); the next n_traced
        # frames are traced and exported.
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(
                wait=0, warmup=PROFILER_WARMUP, active=n_traced, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(trace_path)))
        prof.__enter__()
        span = torch.profiler.record_function
    frame_s, steps, raised, i = [], 0, 0, 0
    while True:
        driver.before_frame(i)
        t = time.perf_counter()
        try:
            n = driver.frame(span)
        except Exception:  # noqa: BLE001 — a failed frame ends the window
            out(traceback.format_exc())
            raised = 1
            break
        frame_s.append(time.perf_counter() - t)
        steps += n
        i += 1
        if prof is not None:
            prof.step()
            if i == PROFILER_WARMUP + n_traced:
                prof.__exit__(None, None, None)
                prof = None
        driver.after_frame(i - 1)
        if sum(frame_s) >= seconds and prof is None:
            break
    window_s = sum(frame_s)
    tenth = max(1, len(frame_s) // 10)
    out("frame ms, median of each tenth of the window: " + ", ".join(
        f"{1e3 * statistics.median(frame_s[k:k + tenth]):.2f}"
        for k in range(0, len(frame_s), tenth)))
    if prof is not None:
        prof.__exit__(None, None, None)
    failed = raised + driver.bad_frames()
    dev_info = {"platform": "gpu" if dev == "cuda" else dev,
                "kind": (torch.cuda.get_device_name() if dev == "cuda"
                         else dev),
                "count": 1}
    if dev == "cuda":
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        per_step = {k: (v - launches0.get(k, 0)) / max(steps, 1)
                    for k, v in LAUNCHES.items()}
        out(f"kernel launches a step: {per_step}")
        out(f"card after the window: {device.card_state()}")
    info = driver.finish()
    out(f"window: {len(frame_s)} frames, {steps} steps, {window_s:.3f} s; "
        f"peak memory {dev_info.get('memory_peak_bytes')}; {info}")

    ctx = SimpleNamespace(setup_s=setup_s, frame_s=frame_s, steps=steps,
                          window_s=window_s, units=driver.units,
                          bonds=getattr(driver, "bonds", 0), trace=None,
                          traced_frames=n_traced,
                          traced_steps=n_traced * driver.steps_per_frame)
    result = {}
    if traced:
        tr = trace.load(trace_path)
        ctx.trace = tr
        win = tr.window()
        dev_info["busy_s"] = trace.device_busy(tr, [win]) if win else 0.0
        dev_info["window_s"] = (win[1] - win[0]) if win else 0.0
        result["breakdown"] = trace.breakdown(tr)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t = time.perf_counter()
    readings = driver.check(control=control)
    limits = cell.config["limits"]
    # The configuration's `limits` names the numbers compared; the others
    # are printed. A reading that is not finite (a non-finite state) is
    # given as 1e300, so the line stays valid JSON.
    out("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in readings.items() if k not in limits))
    checks = {k: {"value": v if math.isfinite(v) else 1e300,
                  "limit": limits[k]}
              for k, v in readings.items() if k in limits}
    out(f"reference checks took {time.perf_counter() - t:.3f} s")
    correct = (failed == 0 and set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"correct": correct, "attempted": len(frame_s) + raised,
            "failed": failed, "metrics": metrics, "device": dev_info,
            **result, "checks": checks}


PROFILER_WARMUP = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    device.require_cards(int(cell.entry["chips"]))
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    guard("after the window")
    for k, c in res["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {res['correct']}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
