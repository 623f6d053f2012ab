"""Design probe of the colony kernels K4 (csrc/contact_sweep.cu) and K5
(csrc/expand_rows.cu) on one CUDA card: the 1,048,576-cell colony of
chip_smoke.py, packed settled and compressed ×0.7, then each band height
K4 can take, through the wrapper (ops/contact.py) with the band plan
forced, checked bitwise against the plain sweep and timed with CUDA
events.

    python3 tools/probe_contact_sweep.py [--rows 1,2,3,4] [--sass]

Prints the card's name and power limit, the ptxas lines of the two
sources' kernels, the listed bands of each copy, one line per band height
and copy (ms of two 20-call runs, the shared-memory bytes, whether the
result was bitwise), then each
kernel's device time by launch under torch.profiler (10 calls) at the
chosen plan, and with --sass the SASS opcode counts of the sweep kernels
(cuobjdump).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,2,3,4")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    from chip_smoke import COLONY_KW, COLONY_N, contact_band_line, cuda_ms
    from probe_band_sweep import sass
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.ops import contact as oc
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.ops.expand import expand_rows
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import compressed

    lib = library()
    print(f"build {lib.seconds:.1f} s", flush=True)
    lines = lib.log.splitlines()
    for i, line in enumerate(lines):
        if ("contact_sweep" in line or "expand_rows" in line) and \
                "Compiling" in line:
            for follow in lines[i:i + 3]:
                print("ptxas:", follow.strip())

    dev = torch.device("cuda", 0)
    state, p, _ = bonded_colony(COLONY_N, device=dev, **COLONY_KW)
    spec = cd.make_contact_spec(p, k=p.dense_k,
                                cell_factor=p.dense_cell_factor)
    copies = {}
    for name, st in (("settled", state), ("compressed", compressed(state,
                                                                  0.7))):
        fields, occ, _, _ = cd._pack_args(st, spec, expand=True)
        plain = cd._sweep_plain(
            fields, lambda *a: cd.contact_pair_terms(p, *a), 6, spec)
        copies[name] = (fields, occ, plain)
        print(f"{name}: {contact_band_line(occ, spec)}", flush=True)

    def exact(kern, plain):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(kern, plain))

    chosen = oc.band_plan
    try:
        for rows in (int(r) for r in args.rows.split(",")):
            q = oc._plan(spec, rows)
            if q.smem_bytes > oc.SMEM_LIMIT:
                continue
            oc.band_plan = lambda _spec, q=q: q
            for name, (fields, occ, plain) in copies.items():
                def run(f=fields, o=occ):
                    return oc.contact_sweep(f, o, p, spec)
                ok = exact(run(), plain)
                t = [cuda_ms(run, 20) for _ in range(2)]
                print(f"rows {rows} {name}: smem {q.smem_bytes} B, "
                      f"{t[0]:.4f}/{t[1]:.4f} ms, bitwise {ok} | {card}",
                      flush=True)
    finally:
        oc.band_plan = chosen

    from torch.profiler import ProfilerActivity, profile

    rows_, _, fits, key, _, _ = cd._sort_with_payload(state, spec)
    runs = {f"contact {name}": (lambda f=f, o=o: oc.contact_sweep(
        f, o, p, spec)) for name, (f, o, _) in copies.items()}
    runs["expand"] = lambda: expand_rows(rows_, key, cd.PACK_FILLS, spec)
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
            if us > 0:
                print(f"profile {name}: {e.key[:60]} {us / 10 / 1e3:.4f} "
                      f"ms/call ({e.count} launches)")
    if args.sass:
        sass(lib.path, "contact_band_kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
