"""The compared numbers of a cell over many seeds in one process: the
program's (its lower readings) and the control's, the reference in
bfloat16 in the program's place (its upper readings). One JSON line per
run on stdout; set-up is paid per run, the kernel build once.

    python -m benchmark.tools.readings --workload CELL --seconds S
        --seeds A,B,... [--control-seeds C,D,...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.harness import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    from benchmark.run import log, run_cell

    bench = spec.load_benchmark()
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        cell = spec.find_cell(bench, args.workload)
        res = run_cell(cell, seed, args.seconds, False,
                       t0=time.perf_counter(), control=control, out=log)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "correct": res["correct"],
                          "frames": res["attempted"],
                          "failed": res["failed"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "readings": {k: v["value"] for k, v in
                                       res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
