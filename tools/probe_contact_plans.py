"""K4's band plans and design variants on one CUDA card: the screen mode
(S3), the pads mode (S2) and the production sweep (K4) of
csrc/contact_sweep.cu at forced plans on chip_smoke.py's settled
1,048,576-cell colony and its copy compressed ×0.7, so that plans and
designs can be compared in one call on one card.

    python3 tools/probe_contact_plans.py [--plans 2,4] [--root DIR]
                                         [--out FILE]

Each plan is the arguments that the tree's ops/contact.py `_plan` takes
after the spec, joined by "x" (this tree: the band rows; a variant's plan
may take more, as a staging ring's took rows x ring slots x chunk
planes); it replaces `band_plan` for the colony's spec (a plan that needs
more shared memory than a block has is skipped); the modes are first held
bitwise to their plain versions at the
plan's rows (chip_smoke.py `floor_exact`; K4 to `_sweep_plain`), then timed: device ms a call
under torch.profiler (one kernel a call, asserted) and ms by CUDA events
(two runs of 20 calls), with the blocks the occupancy API puts on an SM.
`--time-only` skips the checks: for a variant stripped of a stage to time
the rest, which computes something else (its rows say "checked": false);
`--modes` picks the modes timed.
The plan `band_plan` picks runs first. `--root` is the checkout whose
`sph_tpu_torch` is imported (default: this one; a design variant is a
patched copy of the package under the ignored `build/`); the helpers are
this checkout's chip_smoke.py. Prints the card's `nvidia-smi` name and
power limit, the ptxas lines of the contact kernels, one JSON line per
(plan, mode, colony) and, with --out, all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", default="2,4")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--modes", default="screen,full,pads")
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.ops import contact as oc
    from sph_tpu_torch.ops import contact_floor as cf
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import check_contact_fields, compressed

    card = cs.card_line()
    print(f"card: {card}; package {os.path.dirname(oc.__file__)}",
          flush=True)
    lines = library().log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "contact" in line:
            for follow in lines[i:i + 4]:
                print("ptxas:", follow.strip(), flush=True)
    dev = torch.device("cuda", 0)
    state, p, _ = bonded_colony(cs.COLONY_N, device=dev, **cs.COLONY_KW)
    spec = cd.make_contact_spec(p, k=p.dense_k,
                                cell_factor=p.dense_cell_factor)
    packs = {"settled": cd._pack_args(state, spec, expand=True)[:2],
             "compressed x0.7": cd._pack_args(compressed(state, 0.7), spec,
                                              expand=True)[:2]}
    chosen = oc.band_plan(spec)
    plans = [("band_plan", chosen)] + [
        (text, oc._plan(spec, *(int(v) for v in text.split("x"))))
        for text in args.plans.split(",") if text]
    rows_out = []
    band_plan = oc.band_plan
    try:
        for tag, q in plans:
            if q.smem_bytes > oc.SMEM_LIMIT:
                print(f"skip {q}: more shared memory than a block has",
                      flush=True)
                continue
            oc.band_plan = lambda _spec, q=q: q
            blocks = ({m: oc.resident_blocks(spec, m, q, dev)
                       for m in ("pads", "screen", "full")}
                      if hasattr(oc, "resident_blocks") else {})
            for name, (fields, occ) in packs.items():
                if not args.time_only:
                    outs = {m: cf.contact_floor(fields, occ, p, spec, m)
                            for m in ("pads", "screen", "full")}
                    cs.floor_exact(f"{tag} {name}", outs, fields, occ, p,
                                   spec)
                    cs.exact_contact(f"{tag} {name}", check_contact_fields(
                        fields, occ, p, spec))
                busy = cs.pass1_threads(occ, spec, q.rows)
                for m in args.modes.split(","):
                    fn = (lambda m=m, f=fields, o=occ:
                          cf.contact_floor(f, o, p, spec, m))
                    runs = [cs.cuda_ms(fn, 20) for _ in range(2)]
                    dev_ms, kernel, _ = cs.one_kernel(f"{tag} {m}", fn)
                    row = {"plan": tag, "colony": name, "mode": m,
                           "device_ms": dev_ms, "runs_ms": runs,
                           "blocks_per_sm": blocks.get(m),
                           "rows": q.rows, "smem_bytes": q.smem_bytes,
                           "pass1_threads": busy, "chosen": q == chosen,
                           "checked": not args.time_only,
                           "card": card}
                    print(json.dumps(row), flush=True)
                    rows_out.append(row)
    finally:
        oc.band_plan = band_plan
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": args.root, "rows": rows_out},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
