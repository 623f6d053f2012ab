"""K4's floor split on one CUDA card: the counterpart of
tools/probe_kernel_floor.py, with its scene, a settled bonded colony
(102,400 cells by default) of

    bonded_colony(n, neighbor_mode="dense", grid_dim=48, grid_cell_size=4.0,
                  cell_capacity=16, max_splits_per_step=64, dense_k=2,
                  use_pallas=True)

packed once. Each stage mode of the contact sweep (ops/contact_floor.py:
zero, pads, screen, full) is checked bitwise against its plain version
("full" against contact_sweep) and timed with CUDA events (turns plain,
kernel, kernel, plain), beside the bytes and operations its function needs
and the bound they set; then the split: the empty launch (zero), staging
and pads (pads − zero), staging, list and pass 1 (screen − zero),
screen − pads, and the pair terms (full − screen), from the device times
under torch.profiler. The pads mode reads the six fields the production
sweep does not stage and writes a plane, so its difference over-counts
the staging and screen − pads is no stage of its own; the screen mode
stores only in bands that hit. Last, where a call's time goes
between host and device for the zero and full modes.

    python3 tools/probe_kernel_floor_torch.py [n]

Prints the card's `nvidia-smi` name and power limit first.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 102_400
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    from chip_smoke import (
        COLONY_KW,
        card_line,
        contact_band_line,
        cuda_ms,
        device_busy,
        floor_drive,
        floor_exact,
        floor_pairs,
        floor_times,
    )
    from sph_tpu_torch.engine.colony import bonded_colony
    from sph_tpu_torch.ops.build import library
    from sph_tpu_torch.physics import contact_dense as cd

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"build {library().seconds:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    state, p, _ = bonded_colony(n, device=dev, **COLONY_KW)
    spec = cd.make_contact_spec(p, k=p.dense_k,
                                cell_factor=p.dense_cell_factor)
    fields, occ, _, _ = cd._pack_args(state, spec, expand=True)
    print(f"n={n} layout {list(spec.shape())}: "
          f"{contact_band_line(occ, spec)}", flush=True)
    outs = floor_drive({"probe": (fields, occ, p, spec)})["probe"]
    floor_exact(f"{n} colony", outs, fields, occ, p, spec)
    print("bitwise: every stub to its plain version, full to "
          "contact_sweep", flush=True)
    floor_times(f"{n} colony", fields, occ, p, spec, card)
    # Where a call's time goes between host and device: 200 calls timed
    # with CUDA events, and 20 under the profiler (wall against busy).
    pairs = floor_pairs(fields, occ, p, spec)
    for mode in ("zero", "full"):
        kern = pairs[mode][0]
        print(f"{mode}: events over 200 calls {cuda_ms(kern, 200):.4f} ms a "
              f"call; 20 calls profiled: "
              f"{device_busy(lambda: [kern() for _ in range(20)], card)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
