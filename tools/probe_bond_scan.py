"""Kernel A2 (the planned adhesion accumulate, `csrc/adhesion.cu`) on one
CUDA card: checked, then timed at the 1M colony.

    python3 tools/probe_bond_scan.py [--check-only] [--out FILE]

- its ptxas lines (registers, spills, shared memory) for its two kernels;
- A2 bitwise (NaN payloads too) to the plain planned accumulate on the
  card: random plans (one block; 24 and 1,000 blocks; runs across block
  edges; NaN, ±inf and −0 rows), each without and with a zero_bond mask,
  and `utils.verify.END_PLANS` on rows of −0; then
  chip_smoke.py's 1,048,576-cell colony, A1's rows as built and with
  `bond_edge_cases`, and with the hybrid's mask of 2,000 drifted bonds;
- unless `--check-only`, at the 1M colony: A2 against the plain version
  (CUDA events, plain, kernel, kernel, plain), its device time by kernel
  under torch.profiler, host enqueue time, its bounds by bytes and by
  32-byte sectors; the quiet hybrid
  accumulate (the `sph.adhesion.accumulate` span's work) through A2
  against the same through the plain version, in turns; one planned
  colony step by host clock with its launches.

Prints the card's `nvidia-smi` name and power limit and one JSON line per
result; with --out, all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

KERNELS = ("scan_blocks_kernel", "scan_finish_kernel")
# (cells, bonds, seed, active, special), as tests/test_torch_cuda.py's.
CASES = {
    "one block": (40, 200, 1, 0.7, False),
    "24 blocks": (300, 6144, 2, 0.7, False),
    "23 blocks, runs across blocks": (9, 5800, 3, 0.9, False),
    "NaN, inf, -0 rows": (300, 6144, 6, 0.7, True),
    "1,000 blocks": (100_000, 256_000, 9, 0.8, True),
}


def helpers():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def ptxas_lines(log: str, kernel: str) -> list:
    """The ptxas lines of the entry functions whose name holds `kernel`,
    with their stack and spill line."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("ptxas" in line or "spill" in line):
            out.append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    h = helpers()
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.step import run_steps
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.ops import adhesion as oa
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.physics import adhesion as adh
    from sph_tpu_torch.utils.verify import (
        END_PLANS,
        bond_edge_cases,
        bond_scan_case,
        check_bond_scan,
        end_plan,
    )

    dev = torch.device("cuda", 0)
    card = h.card_line()
    rows: list = []
    emit(rows, {"card": card, "torch": torch.__version__,
                "cuda": torch.version.cuda})
    lib = library()
    emit(rows, {"build_s": lib.seconds,
                "ptxas": {k: ptxas_lines(lib.log, k) for k in KERNELS}})

    def check(name, table, plan, zero_bond=None):
        r = check_bond_scan(table, plan, zero_bond)
        emit(rows, {"check": name, **r})
        if not (r["bitwise"] and r["same_bits"]):
            raise AssertionError(f"{name}: A2 is not bitwise: {r}")

    for case, (cells, bonds, seed, active, special) in CASES.items():
        _, plan, table, zb = bond_scan_case(cells, bonds, seed, active,
                                            special, device=dev)
        check(case, table, plan)
        check(f"{case}, zero_bond", table, plan, zb)
    for name in END_PLANS:
        plan = end_plan(name, device=dev)
        check(name, torch.full((plan.perm.shape[0], 7), -0.0, device=dev),
              plan)

    t0 = time.perf_counter()
    st, p, g = bonded_colony(h.COLONY_N, device=dev, **h.COLONY_KW)
    gd = g.to_device(dev)
    N = st.capacity
    plan = adh.build_bond_plan(st.bonds, N)
    table = oa.bond_rows(st, p, gd)
    mp = table.shape[0]
    emit(rows, {"colony": h.COLONY_N, "bond_rows": st.bonds.capacity,
                "table_rows": mp, "blocks": mp // 512,
                "particles_with_bonds": int(plan.has.sum()),
                "built_s": time.perf_counter() - t0})
    moved = adh.plan_changed(h.drifted(st.bonds, N, 2000), plan)
    check("1M colony, built", table, plan)
    check("1M colony, edge cases",
          oa.bond_rows(bond_edge_cases(st), p, gd), plan)
    check(f"1M colony, hybrid mask of {int(moved.sum())} bonds", table,
          plan, moved)
    if args.check_only:
        return finish(rows, args.out)

    kern, plain, _, bnd, sector_ms = h.bond_scan_pair(table, st.bonds, N)
    ms, plain_ms, turns = h.turns(kern, plain)
    emit(rows, {
        "A2": "bond_scan at the 1M colony", "card_ms": ms,
        "plain_ms": plain_ms, "turns_p_k_k_p": turns,
        "device_ms_by_kernel": h.device_ms(kern),
        "host_enqueue_ms": h.host_ms(kern),
        "plain_host_enqueue_ms": h.host_ms(plain), **bnd,
        "sector_bound_ms": sector_ms, "card": card})

    def quiet_a2():
        return adh.accumulate_bond_deltas_hybrid(table, st.bonds, N, plan)

    kernel_route = oa.bond_scan

    def quiet_eager():
        # The hybrid imports bond_scan at each call: the plain version in
        # its place gives the eager path this span ran before A2.
        oa.bond_scan = adh.accumulate_bond_deltas_planned
        try:
            return adh.accumulate_bond_deltas_hybrid(table, st.bonds, N,
                                                     plan)
        finally:
            oa.bond_scan = kernel_route

    a, b = quiet_a2(), quiet_eager()
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))
    k_ms, e_ms, turns = h.turns(quiet_a2, quiet_eager)
    emit(rows, {"quiet hybrid accumulate": "A2 vs eager", "bitwise": same,
                "a2_ms": k_ms, "eager_ms": e_ms, "turns_p_k_k_p": turns,
                "a2_host_enqueue_ms": h.host_ms(quiet_a2),
                "eager_host_enqueue_ms": h.host_ms(quiet_eager),
                "card": card})
    if not same:
        raise AssertionError("quiet accumulate: A2 differs from eager")

    pp = p.replace(adhesion_plan="on")
    run_steps(st, pp, gd, 10)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(st, pp, gd, 20)
    torch.cuda.synchronize()
    emit(rows, {"planned step ms (host clock, 20 steps)":
                (time.perf_counter() - t0) / 20 * 1e3,
                "launches": dict(LAUNCHES), "card": card})
    if LAUNCHES["bond_scan"] != 20:
        raise AssertionError(f"bond_scan launches {dict(LAUNCHES)}")
    return finish(rows, args.out)


def finish(rows, out) -> int:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
