"""The contact pass's slot bookkeeping kernels (`csrc/contact_slots.cu`:
the slots kernel after the pack sort, the gather kernel after K4) on one
CUDA card: checked, then timed at the 1M colony.

    python3 tools/probe_contact_slots.py [--check-only] [--out FILE]

- their ptxas lines (registers, spills, shared memory);
- the slots kernel bitwise to `_rank_and_slots` on `utils.verify.
  SLOT_CASES` for each K the contact sweep is built for, and the gather
  kernel bitwise to `gather_back` with dropped rows and NaN and −0
  planes; then chip_smoke.py's 1,048,576-cell colony, settled and
  compressed ×0.7: both kernels on its own pack, and `contact_forces_dense`
  through them bitwise to the plain route;
- unless `--check-only`, at the 1M colony: each kernel against its plain
  version (CUDA events, plain, kernel, kernel, plain), its device time
  under torch.profiler, host enqueue time and bound by bytes; the contact
  pass through the kernels against the same pass with the plain
  bookkeeping in their place, in turns, with each route's device time by
  operation; one colony step by host clock with its launches.

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

KERNELS = ("contact_slots_kernel", "contact_gather_kernel")


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
    from sph_tpu_torch.engine.step import step
    from sph_tpu_torch.ops import LAUNCHES, reset_launches
    from sph_tpu_torch.ops import contact_slots as ocs
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.ops.contact import SLOT_COUNTS, contact_sweep
    from sph_tpu_torch.physics import contact_dense as cd
    from sph_tpu_torch.utils.verify import (
        SLOT_CASES,
        blob,
        check_contact_gather,
        check_contact_slots,
        compressed,
        slot_case,
    )

    dev = torch.device("cuda", 0)
    card = h.card_line()
    rows: list = []
    emit(rows, {"card": card, "torch": torch.__version__,
                "cuda": torch.version.cuda})
    lib = library()
    emit(rows, {"build_s": lib.seconds,
                "ptxas": {k: ptxas_lines(lib.log, k) for k in KERNELS}})

    for k in SLOT_COUNTS:
        spec = blob(n=8, k=k, spawn=16.0, device="cpu")[2]
        for case in SLOT_CASES:
            n = {"one row": 1, "odd rows": 300_000}.get(case, 5000)
            r = check_contact_slots(*slot_case(spec, case, seed=k, n=n,
                                               device=dev), spec)
            emit(rows, {"check": f"slots, K={k}, {case}", **r})

    t0 = time.perf_counter()
    st, p, g = bonded_colony(h.COLONY_N, device=dev, **h.COLONY_KW)
    spec = cd.make_contact_spec(p, k=p.dense_k,
                                cell_factor=p.dense_cell_factor)
    emit(rows, {"colony": h.COLONY_N, "slots": spec.slots,
                "layout": list(spec.shape()),
                "built_s": time.perf_counter() - t0})
    states = {"settled": st, "compressed x0.7": compressed(st, 0.7)}
    for name, s in states.items():
        cid_s, order = torch.sort(cd._cell_ids(s, spec), stable=True)
        emit(rows, {"check": f"slots at 1M, {name}",
                    **check_contact_slots(cid_s, order, spec)})
        fields, occ, slot_of, ovr = cd._pack_args(s, spec)
        comps = [c.reshape(-1) for c in contact_sweep(fields, occ, p, spec)]
        emit(rows, {"check": f"gather at 1M, {name}",
                    **check_contact_gather(comps, slot_of, ovr)})
        planes = [c.clone() for c in comps]
        for c, plane in enumerate(planes):
            plane[slot_of[c::13].long().clamp(max=spec.slots - 1)] = (
                float("nan") if c % 2 else -0.0)
        dropped = slot_of.clone()
        dropped[::9] = spec.slots
        emit(rows, {"check": f"gather at 1M, {name}, NaN and -0 planted, "
                             f"every 9th dropped",
                    **check_contact_gather(planes, dropped, ovr)})
        got = cd.contact_forces_dense(s, p, spec)
        want = cd.contact_forces_dense(s, p.replace(use_pallas=False), spec)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got[:2], want[:2]))
        emit(rows, {"check": f"contact_forces_dense at 1M, {name}, kernels "
                             f"vs plain", "bitwise": same,
                    "overflow": [int(got[2]), int(want[2])],
                    "max_force": float(want[0].abs().max())})
        if not same or int(got[2]) != int(want[2]):
            raise AssertionError(f"contact forces at 1M, {name}: the "
                                 f"kernel route differs from the plain one")
    if args.check_only:
        return finish(rows, args.out)

    slots_pair, gather_pair = h.contact_slot_pairs(st, p, spec)
    for name, (kern, plain, _, bnd) in (("contact_slots", slots_pair),
                                        ("contact_gather", gather_pair)):
        ms, plain_ms, turns = h.turns(kern, plain)
        emit(rows, {
            "kernel": name, "card_ms": ms, "plain_ms": plain_ms,
            "turns_p_k_k_p": turns, "device_ms_by_kernel": h.device_ms(kern),
            "plain_device_ms_by_kernel": h.device_ms(plain),
            "host_enqueue_ms": h.host_ms(kern),
            "plain_host_enqueue_ms": h.host_ms(plain), **bnd, "card": card})

    def kernels():
        return cd.contact_forces_dense(st, p, spec)

    def plain_bookkeeping():
        # The kernel route with the plain bookkeeping in the slot kernels'
        # place: the contact pass as it ran before them.
        saved = ocs.rank_and_slots, ocs.gather_back
        ocs.rank_and_slots, ocs.gather_back = (cd._rank_and_slots,
                                               cd.gather_back)
        try:
            return cd.contact_forces_dense(st, p, spec)
        finally:
            ocs.rank_and_slots, ocs.gather_back = saved

    k_ms, e_ms, turns = h.turns(kernels, plain_bookkeeping)
    emit(rows, {"contact pass": "slot kernels vs plain bookkeeping",
                "kernels_ms": k_ms, "plain_ms": e_ms, "turns_p_k_k_p": turns,
                "kernels_host_enqueue_ms": h.host_ms(kernels),
                "plain_host_enqueue_ms": h.host_ms(plain_bookkeeping),
                "kernels_device_ms_by_op": h.device_ms(kernels),
                "plain_device_ms_by_op": h.device_ms(plain_bookkeeping),
                "card": card})

    gd = g.to_device(dev)
    for _ in range(3):
        st = step(st, p, gd)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        st = step(st, p, gd)
    torch.cuda.synchronize()
    emit(rows, {"colony step ms (host clock, 20 steps)":
                (time.perf_counter() - t0) / 20 * 1e3,
                "launches": dict(LAUNCHES), "card": card})
    if LAUNCHES["contact_slots"] != 20 or LAUNCHES["contact_gather"] != 20:
        raise AssertionError(f"slot kernel launches {dict(LAUNCHES)}")
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
