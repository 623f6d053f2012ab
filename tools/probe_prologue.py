"""K4's and K5's launch structure on one CUDA card: every kernel of the
colony contact path at the shapes the port runs it, checked against its
plain version and timed, for one checkout of the port — so that two trees
(a parent unpacked under the ignored `build/`, and this one) can be run in
turns in one call and compared on one card.

    python3 tools/probe_prologue.py [--root DIR] [--out FILE]

`--root` is the checkout whose `sph_tpu_torch` is imported (default: this
one); the helpers (timers, bounds, the floor pairs) are this checkout's
chip_smoke.py. On the 1,048,576-cell colony of chip_smoke.py and on
tools/probe_kernel_floor.py's 102,400-cell colony: K4 (contact_sweep) and
its floor modes S1–S3, with torch.zeros of the six planes beside S1; K4
also on the 1M colony compressed ×0.7 and on two ranks' halo-padded blocks
of the 1M pack (a 4-ring's rank 1, a 2×2 mesh's rank (1, 0)); K5
(expand_rows) at 1M and at the expand probe's 400-cell scene (K6), with
torch.index_copy beside each. Each: ms over 20 calls with CUDA events
(two runs), device ms and kernels a call under torch.profiler, host
enqueue ms a call, the bound; K4, S1–S3 and K5 bitwise to their plain
versions first. Also, a colony, the blocks an SM of each mode (the
occupancy API, where the tree has `resident_blocks`) and the threads busy
in pass 1 (chip_smoke.py `pass1_threads`). Prints the card's `nvidia-smi` name and power limit, the
ptxas lines of the two sources, and one JSON line per kernel; with --out,
all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def helpers():
    """This checkout's chip_smoke.py, whatever tree is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(cs, name: str, fn, library_call, bnd: dict, card: str) -> dict:
    runs = [cs.cuda_ms(fn, 20) for _ in range(2)]
    by_kernel = cs.device_ms(fn)
    row = {
        "name": name, "ms": sum(runs) / 2, "runs_ms": runs,
        "device_ms": sum(v[0] for v in by_kernel.values()) or None,
        "kernels_a_call": sum(v[1] for v in by_kernel.values()) / 10,
        "by_kernel": by_kernel, "host_enqueue_ms": cs.host_ms(fn),
        "library_ms": (None if library_call is None
                       else cs.cuda_ms(library_call, 20)),
        **bnd, "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


def run(root: str, out: str | None, cs, device="cuda:0") -> list:
    """The probe on the tree at `root` (first on sys.path) with the helpers
    `cs`; returns the rows (and writes them to `out` when given)."""
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.ops import contact as oc
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.ops.contact import contact_sweep
    from sph_tpu_torch.parallel.dist import contact_block
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import (
        blob,
        check_contact_fields,
        check_expand,
        compressed,
    )

    card = cs.card_line()
    print(f"card: {card}; tree {root}", flush=True)
    if not inspect.getfile(contact_sweep).startswith(root + os.sep):
        raise RuntimeError(f"sph_tpu_torch comes from "
                           f"{inspect.getfile(contact_sweep)}, not {root}")
    lib = library()
    lines = lib.log.splitlines()
    ptxas = [follow.strip() for i, line in enumerate(lines)
             if "Compiling entry" in line
             and ("contact" in line or "expand" in line)
             for follow in lines[i:i + 4]]
    for line in ptxas:
        print("ptxas:", line, flush=True)
    dev = torch.device(device)
    rows = []
    for n in (cs.COLONY_N, cs.FLOOR_N):
        state, p, _ = bonded_colony(n, device=dev, **cs.COLONY_KW)
        spec = cd.make_contact_spec(p, k=p.dense_k,
                                    cell_factor=p.dense_cell_factor)
        fields, occ = cd._pack_args(state, spec, expand=True)[:2]
        tag = f"{n} colony {list(spec.shape())}"
        print(f"{tag}: {cs.contact_band_line(occ, spec)}", flush=True)
        plan = oc.band_plan(spec)
        blocks = ({m: oc.resident_blocks(spec, m, plan, dev)
                   for m in ("zero", "pads", "screen", "full")}
                  if hasattr(oc, "resident_blocks") else "not available")
        print(f"{tag}: blocks an SM (occupancy API) {blocks}; threads busy "
              f"in pass 1 of 256 {cs.pass1_threads(occ, spec, plan.rows)}",
              flush=True)
        r = check_contact_fields(fields, occ, p, spec)
        cs.exact_contact(tag, r)
        pairs = cs.floor_pairs(fields, occ, p, spec)
        cs.floor_exact(tag, cs.floor_drive(
            {tag: (fields, occ, p, spec)})[tag], fields, occ, p, spec)
        for mode, (kern, _, library_call, nbytes, flops) in pairs.items():
            name = {"full": "K4", "zero": "S1", "pads": "S2",
                    "screen": "S3"}[mode]
            rows.append(timed(cs, f"{name} {tag}", kern, library_call,
                              cs.bound(nbytes, flops), card))
        if n != cs.COLONY_N:
            continue
        fields_c, occ_c = cd._pack_args(compressed(state, 0.7), spec,
                                        expand=True)[:2]
        _, (kern, _, _, bnd) = cs.contact_pair(fields_c, occ_c, p, spec)
        rows.append(timed(cs, f"K4 {tag} compressed x0.7", kern, None, bnd,
                          card))
        for shape, coords in (((4,), (1,)), ((2, 2), (1, 0))):
            block, sspec = contact_block([*fields, occ], spec, shape, coords)
            where = f"K4 1M block {coords} of {shape} {list(block[10].shape)}"
            cs.exact_contact(where, check_contact_fields(
                block[:10], block[10], p, sspec))
            _, (kern, _, _, bnd) = cs.contact_pair(block[:10], block[10], p,
                                                   sspec)
            rows.append(timed(cs, where, kern, None, bnd, card))
        check_expand(state, spec)
        kern, _, library_call, bnd = cs.expand_pair(state, spec)
        rows.append(timed(cs, f"K5 {tag}", kern, library_call, bnd, card))
        del state, fields, occ, fields_c, occ_c
        torch.cuda.empty_cache()
    s6, _, spec6 = blob(n=400, k=4, seed=3, radius=9.0, spawn=10.0,
                        radii=(2.0, 2.0), device=dev)
    check_expand(s6, spec6)
    kern, _, library_call, bnd = cs.expand_pair(s6, spec6)
    rows.append(timed(cs, f"K6 (K5 at the probe scene {list(spec6.shape())})",
                      kern, library_call, bnd, card))
    print(f"bitwise: K4 and S1-S3 at both colonies and the blocks, K5 at 1M "
          f"and the probe scene; the package: "
          f"{os.path.dirname(inspect.getfile(contact_sweep))}", flush=True)
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)     # before chip_smoke.py imports the package
    run(root, args.out, helpers())
    return 0


if __name__ == "__main__":
    sys.exit(main())
