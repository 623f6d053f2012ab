"""Kernel A1 (the adhesion pass's per-bond rows, `csrc/adhesion.cu`) on
one CUDA card: checked, then timed at the 1M colony.

    python3 tools/probe_bond_rows.py [--check-only] [--out FILE]

- its ptxas lines (registers, spills);
- how torch's CUDA `sum` over a last dim of 3 adds (the order A1 follows);
- A1 bitwise to the plain `bond_rows` on the card: a 4,096-cell colony as
  built, with `bond_edge_cases` (NaN endpoints included), loaded with the
  anchor constraints off, with 8,229 bond rows; then chip_smoke.py's
  1,048,576-cell colony as built and with the edge cases;
- unless `--check-only`, at the 1M colony: A1 against the plain version
  (CUDA events, plain, kernel, kernel, plain), its device time under
  torch.profiler and host enqueue time, its bound; the whole adhesion pass
  (`bond_deltas` with the plan, the quiet branch) through A1 against the
  same pass fed the plain rows (the eager chain A1 replaces), in turns;
  and one planned colony step by host clock.

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

# By 32-byte sectors each of a bond's eight endpoint fields (position,
# velocity, rotation and mass of two cells, 88 B) is at least one sector.
SECTOR_EXTRA_BYTES = 8 * 32 - 88


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
    """The ptxas lines of the entry functions whose name holds `kernel`."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and "ptxas" in line:
            out.append(line.strip())
    return out


def sum3_order(dev) -> dict:
    """torch.sum over 3 against (x0 + x2) + x1 and (x0 + x1) + x2 on 2^22
    rows with −0 entries, bits compared (+0 is not −0)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((1 << 22, 3), generator=g, device=dev) - 0.5) * 3.0
    x[torch.rand(x.shape, generator=g, device=dev) < 0.2] = -0.0
    s = torch.sum(x, dim=-1)
    a = (x[:, 0] + x[:, 2]) + x[:, 1]
    b = (x[:, 0] + x[:, 1]) + x[:, 2]

    def same(u, v):
        return torch.equal(u.view(torch.int32), v.view(torch.int32))

    return {"sum3 = (x0 + x2) + x1, then + 0": same(s, a + 0.0),
            "sum3 = (x0 + x2) + x1": same(s, a),
            "sum3 = (x0 + x1) + x2, then + 0": same(s, b + 0.0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    h = helpers()
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.engine.step import run_steps
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.physics import adhesion as adh
    from sph_tpu_torch.utils.verify import bond_edge_cases, check_bond_rows

    dev = torch.device("cuda", 0)
    card = h.card_line()
    rows: list = []
    emit(rows, {"card": card, "torch": torch.__version__,
                "cuda": torch.version.cuda})
    lib = library()
    emit(rows, {"build_s": lib.seconds,
                "ptxas": ptxas_lines(lib.log, "bond_rows_kernel")})
    emit(rows, {"torch_sum3": sum3_order(dev)})

    def check(name, state, params, gd, **kw):
        r = check_bond_rows(state, params, gd, **kw)
        emit(rows, {"check": name, **r})
        if not r["bitwise"]:
            raise AssertionError(f"{name}: A1 is not bitwise: {r}")

    kw = dict(h.COLONY_KW)
    for case in ("built", "edge cases", "anchors off", "8229 bond rows"):
        extra = {"max_bonds": 8229} if case == "8229 bond rows" else {}
        st, p, g = bonded_colony(4096, device=dev, **kw, **extra)
        gd = g.to_device(dev)
        if case != "built":
            st = bond_edge_cases(st, nan=case != "anchors off")
        if case == "anchors off":
            p = p.replace(enable_anchor_constraints=False)
        check(f"4096 cells, {case}", st, p, gd)
        check(f"4096 cells, {case}, dt x0.37", st, p, gd, dt=0.37 * p.dt)
    t0 = time.perf_counter()
    st, p, g = bonded_colony(h.COLONY_N, device=dev, **kw)
    gd = g.to_device(dev)
    B = st.bonds.capacity
    emit(rows, {"colony": h.COLONY_N, "bond_rows": B,
                "active_bonds": int(st.bonds.active.sum()),
                "table_rows": adh.padded_rows(B),
                "built_s": time.perf_counter() - t0})
    check("1M colony, built", st, p, gd)
    check("1M colony, edge cases", bond_edge_cases(st), p, gd)
    if args.check_only:
        return finish(rows, args.out)

    kern, plain, _, bnd = h.bond_rows_pair(st, p, gd)
    ms, plain_ms, turns = h.turns(kern, plain)
    dev_ms, name, _ = h.one_kernel("bond_rows", kern)
    emit(rows, {
        "A1": "bond_rows at the 1M colony", "card_ms": ms,
        "plain_ms": plain_ms, "turns_p_k_k_p": turns, "device_ms": dev_ms,
        "kernel": name, "host_enqueue_ms": h.host_ms(kern), **bnd,
        "sector_bound_ms": bnd["bound_ms"]
        + B * SECTOR_EXTRA_BYTES / h.HBM_BYTES_PER_S * 1e3, "card": card})

    plan = adh.build_bond_plan(st.bonds, st.capacity)
    N = st.capacity

    def pass_kernel():
        return adh.bond_deltas(st, p, gd, plan=plan)

    def pass_eager():
        return adh.accumulate_bond_deltas_hybrid(plain(), st.bonds, N, plan)

    a, b = pass_kernel(), pass_eager()
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))
    k_ms, e_ms, turns = h.turns(pass_kernel, pass_eager)
    emit(rows, {"adhesion pass (quiet planned)": "kernel vs eager rows",
                "bitwise": same, "kernel_ms": k_ms, "eager_ms": e_ms,
                "turns_p_k_k_p": turns, "card": card})
    if not same:
        raise AssertionError("adhesion pass: A1's sums differ from eager")

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
    if LAUNCHES["bond_rows"] != 20:
        raise AssertionError(f"bond_rows launches {dict(LAUNCHES)}")
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
