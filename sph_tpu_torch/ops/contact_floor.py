"""K4's floor modes: the colony contact sweep run one stage at a time, to
split its time into the empty launch, the halo staging, the screen and the
pair terms.

Counterparts of the stub kernels of tools/probe_kernel_floor.py
(`zero_kernel` :78, `pads_kernel` :84, `screen_kernel` :105), which that
probe swaps into `sph_tpu.ops.pallas.contact._contact_kernel`, so each
reaches the Pallas contact sweep's `pl.pallas_call`. On the card each is a
compile-time stage mode of K4's own band sweep (csrc/contact_sweep.cu
`sph_contact_floor`):

- "zero"   — the gate, then +0 into every listed band's six planes;
- "pads"   — and the halo staging (TMA) and the lane pads;
- "screen" — and the list of the band's occupied slots and pass 1 (the 62
             screens of each at K = 2) as a running margin max; only a
             band that hits stores (pass 1 again, its margins);
- "full"   — the production sweep, `ops.contact.contact_sweep`.

What the stubs compute, on 6 [Z, Y, L] planes. A TILE is `tile_rows` whole
rows of one plane (the last tile of a plane may be shorter); it is GATED
when it holds a slot with occ > 0.5. Every output is +0 outside gated
tiles, and out1..5 are +0 everywhere.

- zero:   out0 = +0.
- pads:   out0 = f32(1e-37) · the sum over the 10 fields (outer) and
          dz ∈ (−1, 0, 1) (inner) of field[z + dz] at the slot's own
          (y, l), summed from +0.
- screen: margin = max(−1, the max over `contact_variants` of
          `contact_screen` on px, py, pz and rad), NaN kept (as
          jnp.maximum and torch.maximum keep it); out0 = margin in a gated
          tile whose max margin is > 0 (a NaN max is not), else +0.

The card's tile is the kernel's band (`band_plan(spec).rows`: 3 at the 1M
colony), the Pallas kernel's the row block YB of `_pick_yb` (48 there);
the plain versions take it as `tile_rows`, and the wrapper gives them the
band's rows.

Partners wrap in every axis, as `_sweep_plain`'s torch.roll and the
kernel's halo staging wrap them. The Pallas kernel clamps planes and
edge tiles instead; on a pack those reach only slots of the sentinel
margin (own or partner, on an own slot whose screen is below −1 either
way), so wrap and clamp give the same bits there. Input that is not a
pack is not a contract: the kernel's screen mode also screens only the
occupied slots, as the production sweep does, and writes −1 to the empty
slots of a band that hits — what a pack's radius fill (−1e3) makes their
margin.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises — there is no fallback. The stage modes are probes: no step
launches them, and they count apart from the production kernels
(`ops.FLOOR_LAUNCHES`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sph_tpu_torch.ops import FLOOR_LAUNCHES
from sph_tpu_torch.ops.build import library
from sph_tpu_torch.ops.contact import (
    NCOMP,
    contact_sweep,
    launch_bands,
    plan_of,
)

MODES = ("zero", "pads", "screen", "full")
STUBS = ("zero", "pads", "screen")    # mode code = index (Mode in the .cu)
PADS_SCALE = 1e-37                    # the pads stub's f32 factor


def _tiles(x, tile_rows: int) -> torch.Tensor:
    """[Z, Y, L] → [Z, tiles, tile_rows·L]: each tile's slots, the last
    tile of a plane padded with −1 (below every margin but NaN, and no
    occupancy)."""
    Z, Y, L = x.shape
    tiles = -(-Y // tile_rows)
    padded = F.pad(x, (0, 0, 0, tiles * tile_rows - Y), value=-1.0)
    return padded.view(Z, tiles, tile_rows * L)


def _per_slot(t, tile_rows: int, Y: int) -> torch.Tensor:
    """A per-tile [Z, tiles] value at every slot: [Z, Y, 1]."""
    return t.repeat_interleave(tile_rows, dim=1)[:, :Y, None]


def tile_gate(occ, tile_rows: int) -> torch.Tensor:
    """[Z, Y, 1] bool: the slot's tile holds a slot with occ > 0.5."""
    live = (_tiles(occ, tile_rows) > 0.5).any(dim=2)
    return _per_slot(live, tile_rows, occ.shape[1])


def zero_plain(fields, occ, params, spec, tile_rows: int):
    """The zero stub: +0 in all six planes."""
    return [torch.zeros_like(occ) for _ in range(NCOMP)]


def pads_plain(fields, occ, params, spec, tile_rows: int):
    """The pads stub: f32(1e-37) times the sum of every field over the
    planes z − 1, z, z + 1 at the own (y, l), in gated tiles."""
    acc = torch.zeros_like(occ)
    for f in fields:
        for dz in (-1, 0, 1):
            acc = acc + torch.roll(f, -dz, 0)
    scale = torch.full((), PADS_SCALE, dtype=torch.float32, device=acc.device)
    out = zero_plain(fields, occ, params, spec, tile_rows)
    out[0] = torch.where(tile_gate(occ, tile_rows), acc * scale, 0.0)
    return out


def screen_margin(fields, params, spec) -> torch.Tensor:
    """max(−1, every variant's contact_screen) per slot, NaN kept."""
    from sph_tpu_torch.physics import contact_dense as cd

    F4 = torch.stack([fields[i] for i in (0, 1, 2, 9)])
    margin = torch.full_like(fields[0], -1.0)
    for dz, dy, o in cd.contact_variants(spec):
        q = torch.roll(F4, (-dz, -dy, -o), (1, 2, 3))
        margin = torch.maximum(
            margin, cd.contact_screen(params, *F4.unbind(0), *q.unbind(0)))
    return margin


def screen_plain(fields, occ, params, spec, tile_rows: int):
    """The screen stub: the margin in gated tiles whose max margin is
    > 0."""
    margin = screen_margin(fields, params, spec)
    hit = _per_slot(_tiles(margin, tile_rows).amax(dim=2) > 0.0, tile_rows,
                    occ.shape[1])
    out = zero_plain(fields, occ, params, spec, tile_rows)
    out[0] = torch.where(tile_gate(occ, tile_rows) & hit, margin, 0.0)
    return out


PLAIN = {"zero": zero_plain, "pads": pads_plain, "screen": screen_plain}


def contact_floor(fields, occ, params, spec, mode: str,
                  rows: int | None = None):
    """K4 run to stage `mode` (MODES) on the 10 packed planes `fields` and
    the occupancy `occ`: 6 [Z, Y, L] planes. The tile is the band of
    `band_plan(spec)`, or of `rows` rows when given (the band plan forced,
    as the design probes force it); "full" is `contact_sweep` on that
    plan."""
    if mode not in MODES:
        raise ValueError(f"contact_floor: mode {mode!r} is not one of "
                         f"{MODES}")
    if mode == "full":
        return contact_sweep(fields, occ, params, spec, rows=rows)
    plan = plan_of(spec, rows)
    if fields[0].device.type == "cpu":
        return PLAIN[mode](fields, occ, params, spec, plan.rows)
    outs = launch_bands(
        f"contact_floor {mode}", library().lib.sph_contact_floor, fields,
        occ, spec, plan, STUBS.index(mode), params.contact_epsilon)
    FLOOR_LAUNCHES[mode] += 1
    return outs
