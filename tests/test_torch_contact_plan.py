"""The colony kernels' host-side geometry, on the CPU: K4's band planner
(ops/contact.py `band_plan`), its stencil indexing and its wrapper's band
cursor, and K5's row lookup (csrc/expand_rows.cu, written out in plain
PyTorch as sph_tpu_torch.utils.verify `expand_lookup` and
`expand_search`) against the pack's own bookkeeping `_rank_and_slots`.
The kernels themselves are checked on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import pytest
import torch

from sph_tpu_torch.ops import contact as oc
from sph_tpu_torch.ops.expand import RANGE, expand_rows
from sph_tpu_torch.ops.fluid import SMEM_LIMIT, SMEM_TARGET
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.utils.verify import EXPAND_THREADS as THREADS
from sph_tpu_torch.utils.verify import blob, expand_lookup, expand_search

torch.set_num_threads(1)


def blob_spec(k, spawn=10.0):
    return blob(n=8, k=k, spawn=spawn, device="cpu")[2]


# chip_smoke.py's 1,048,576-cell colony: layout [186, 192, 384], K = 2.
COLONY_1M = cd.ContactSpec(nz=186, ny=192, nx=186, nx_pad=192, k=2,
                           cell=2.1, origin=(-195.3, -195.3, -195.3))
SPECS = {
    "colony_1m": lambda: COLONY_1M,
    "blob_k4": lambda: blob_spec(4),
    "blob_k1": lambda: blob_spec(1),
    "y8": lambda: blob_spec(2, spawn=6.0),
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_band_plan_fits_and_covers(case):
    spec = SPECS[case]()
    if case == "y8":
        assert spec.ny == 8
    plan = oc.band_plan(spec)
    # Bands of BAND_ROWS rows (fewer on a shorter plane); four sweep blocks
    # fit on an SM by shared memory (registers allow two).
    assert plan.rows == min(oc.BAND_ROWS, spec.ny)
    assert 4 * (plan.smem_bytes + 1024) <= 233_472
    # Every row of every plane is in exactly one band (the gate's grid).
    seen = torch.zeros((spec.nz, spec.ny), dtype=torch.int64)
    for band in range(spec.nz * plan.bands):
        z, r0 = band // plan.bands, band % plan.bands * plan.rows
        seen[z, r0:min(r0 + plan.rows, spec.ny)] += 1
    assert bool((seen == 1).all())
    if case == "colony_1m":
        assert spec.shape() == (186, 192, 384)
        # Two occupancy buffers and the list of 1,920 slots (23,040 B),
        # 60 mask words, the warp counts and the 32-byte tail; nothing
        # staged.
        assert (plan.rows, plan.bands, plan.smem_bytes) == (5, 39, 23_344)
    # The block holds the band's occupancy and the next band's (two
    # buffers of rows·L floats), the list and a whole number of 32-slot
    # masks.
    own = plan.rows * spec.L
    assert own % 32 == 0
    assert plan.smem_bytes == 4 * (2 * own + own + own // 32
                                   + oc.THREADS // 32) + oc.TAIL


@pytest.mark.parametrize("k", oc.SLOT_COUNTS)
def test_band_plan_at_every_k(k):
    """At each K the kernel is built for, on the 1M colony's layout and on
    a small blob: BAND_ROWS rows (the plane's Y if fewer), shared memory
    under the two-block target, every forced height's plan the same
    formula, and one more row costing one more row of buffers."""
    for spec in (dataclasses.replace(COLONY_1M, k=k), blob_spec(k)):
        plan = oc.band_plan(spec)
        assert plan == oc._plan(spec, min(oc.BAND_ROWS, spec.ny))
        assert plan.bands == -(-spec.ny // plan.rows)
        assert plan.smem_bytes <= SMEM_TARGET <= SMEM_LIMIT
        for rows in (2, 5, 8):
            forced = oc.plan_of(spec, rows)
            assert forced == oc._plan(spec, rows)
            assert forced.smem_bytes - oc._plan(spec, rows - 1).smem_bytes \
                == 4 * (3 * spec.L + spec.L // 32)


def test_band_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="built for K"):
        oc.band_plan(dataclasses.replace(COLONY_1M, k=3))
    with pytest.raises(ValueError, match="more than"):
        oc.band_plan(dataclasses.replace(COLONY_1M, nx_pad=4096 * 4))
    with pytest.raises(ValueError, match="multiple of 32"):
        oc.band_plan(dataclasses.replace(COLONY_1M, nx_pad=200))


def stencil(spec, z, y, l):
    """The kernel's `Stencil` of own slot (z, y, l): nine wrapped row
    starts (dz outer) and 2P + 1 wrapped lanes."""
    P = 2 * spec.k - 1
    Z, Y, L = spec.nz, spec.ny, spec.L
    rows = [((z + dz) % Z * Y + (y + dy) % Y) * L
            for dz in (-1, 0, 1) for dy in (-1, 0, 1)]
    lanes = [(l + o) % L for o in range(-P, P + 1)]
    return rows, lanes


@pytest.mark.parametrize("case", ["blob_k4", "y8"])
def test_band_halo_holds_the_rolled_partners(case):
    """The sweep's partner indices — its `Stencil`: row start of (z + dz, y
    + dy) plus lane l + o, each wrapped, formed once a slot; nothing is
    staged — give at every own slot of a band and every
    variant the plain sweep's rolled partner: for the first band row, the
    last (short or at the array's edge) and one inside, in the first, a
    middle and the last plane, at the first lanes, the last and one
    inside."""
    spec = SPECS[case]()
    plan = oc.band_plan(spec)
    Z, Y, L = spec.nz, spec.ny, spec.L
    P = 2 * spec.k - 1
    g = torch.Generator().manual_seed(1)
    field = torch.rand((Z, Y, L), generator=g)
    flat = field.reshape(-1)
    for z in (0, Z // 2, Z - 1):
        for b in (0, plan.bands // 2, plan.bands - 1):
            r0 = b * plan.rows
            rows = min(plan.rows, Y - r0)
            for ry in (0, rows // 2, rows - 1):
                y = r0 + ry
                for l in (0, 1, L // 2, L - 2, L - 1):
                    row, lane = stencil(spec, z, y, l)
                    for dz, dy, o in cd.contact_variants(spec):
                        want = torch.roll(field, (-dz, -dy, -o),
                                          (0, 1, 2))[z, y, l]
                        got = flat[row[3 * (dz + 1) + dy + 1] + lane[o + P]]
                        assert torch.equal(got, want), (z, y, l, dz, dy, o)
                    assert flat[row[4] + lane[P]] == field[z, y, l]


def slot_rows(flat, fits, slots):
    """The slot → sorted-row map that `_rank_and_slots` implies."""
    want = torch.full((slots,), -1, dtype=torch.int64)
    rows = torch.arange(flat.numel())
    want[flat[fits].long()] = rows[fits]
    return want


def start_table(key, slots, range_slots):
    """The first row whose key ≥ r·range_slots, for r up to the number of
    ranges (n if none): the bounds the lookup must give each range."""
    ranges = -(-slots // range_slots)
    return torch.searchsorted(key.long(),
                              torch.arange(ranges + 1) * range_slots)


@pytest.mark.parametrize("case,kw", [
    ("overflow_and_dead", dict(n=400, k=4, alive=380)),
    ("k2_crowded", dict(n=1500, k=2, radius=8.0, alive=1490)),
    ("k1_all_live", dict(n=300, k=1, seed=5)),
])
@pytest.mark.parametrize("range_slots", [RANGE, 128])
@pytest.mark.parametrize("chunk", [1, 2, 5, "all"])
def test_expand_lookup_places_the_packs_rows(case, kw, range_slots, chunk):
    """The lookup with one range a block (a search each, as the kernel
    runs a small pack), two (as it runs a pack that fills the card), five
    (a cursor carried across four ranges) and every range in one block;
    blocks whose ranges hold no row (the layout's sentinel margin at its
    end) too."""
    st, p, spec = blob(device="cpu", **kw)
    rows, flat, fits, key, overflow, _ = cd._sort_with_payload(st, spec)
    if case != "k1_all_live":
        assert int(overflow) > 0
        assert int((key >= spec.slots).sum()) == st.capacity - kw["alive"]
    ranges = -(-spec.slots // range_slots)
    chunk = ranges if chunk == "all" else chunk
    got, start = expand_lookup(key, spec.slots, chunk, range_slots)
    assert torch.equal(got, slot_rows(flat, fits, spec.slots))
    assert torch.equal(start, start_table(key, spec.slots, range_slots))
    firsts = start[0:ranges:chunk]
    ends = start[torch.clamp(torch.arange(0, ranges, chunk) + chunk,
                             max=ranges)]
    assert bool((firsts == ends).any()) == (chunk < ranges)
    # The key gives the pack's own targets, and the wrapper's plain route
    # places by them.
    tflat, tfits = cd.targets_of_keys(key, spec.slots)
    assert torch.equal(tflat, flat) and torch.equal(tfits, fits)
    out = expand_rows(rows, key, cd.PACK_FILLS, spec)
    planes = cd._scatter_sorted(rows.unbind(1), cd.PACK_FILLS, flat, fits,
                                spec)
    for c, plane in enumerate(planes):
        assert torch.equal(out[c].view(torch.int32),
                           plane.reshape(-1).view(torch.int32)), c


@pytest.mark.parametrize("chunk", [1, 2])
def test_expand_lookup_refuses_flat_where_a_cell_overflows(chunk):
    st, _, spec = blob(n=400, k=4, alive=380, device="cpu")
    _, flat, fits, key, overflow, _ = cd._sort_with_payload(st, spec)
    assert int(overflow) > 0
    # An overflow row's flat = slots sits before rows that fit.
    assert bool((flat[1:] < flat[:-1]).any())
    with pytest.raises(ValueError, match="not nondecreasing"):
        expand_lookup(flat, spec.slots, chunk)
    assert torch.equal(expand_lookup(key, spec.slots, chunk)[0],
                       slot_rows(flat, fits, spec.slots))


def test_expand_lookup_and_wrapper_with_no_rows():
    spec = blob_spec(2)
    key = torch.empty(0, dtype=torch.int32)
    for chunk in (1, 3):
        got, start = expand_lookup(key, spec.slots, chunk, 128)
        assert bool((got == -1).all()) and bool((start == 0).all())
        assert start.numel() == -(-spec.slots // 128) + 1
    flat, fits = cd.targets_of_keys(key, spec.slots)
    assert flat.numel() == 0 and fits.numel() == 0
    out = expand_rows(torch.empty((0, 11)), key, cd.PACK_FILLS, spec)
    want = torch.tensor(cd.PACK_FILLS, dtype=torch.float32)[:, None]
    assert torch.equal(out, want.expand(11, spec.slots))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 70_000,
                               1_048_576])
def test_expand_search_finds_the_first_row_at_least(n):
    """The block search against torch.searchsorted on a nondecreasing key
    with runs and gaps, at targets before, inside and past the keys; it
    takes about log₂₅₇(n / 256) narrowing rounds and the last: 3 at 2^20
    rows."""
    g = torch.Generator().manual_seed(n)
    key = torch.cumsum(torch.randint(0, 3, (n,), generator=g), 0)
    top = int(key[-1]) + 2 if n else 2
    rounds = 0
    for target in sorted({0, 1, top // 3, top // 2, top - 2, top - 1, top}):
        got, r = expand_search(key, target)
        assert got == int(torch.searchsorted(key, target))
        rounds = max(rounds, r)
    want = 1
    while n > THREADS * (THREADS + 1) ** (want - 1):
        want += 1
    assert rounds <= want
    if n == 1_048_576:
        assert rounds == 3


def test_band_cursor_is_kept_per_stream_and_dropped_on_a_failed_launch():
    """The wrapper's band cursor: one zeroed int32 pair per (device,
    stream), made at the first launch and handed to every later one; a
    launch that returns an error drops it and raises."""
    dev = torch.device("cpu")
    seen = []

    def launch(cursor):
        seen.append(cursor)
        return 0

    try:
        oc.launch_on_cursor("t", dev, 7, launch)
        oc.launch_on_cursor("t", dev, 7, launch)
        oc.launch_on_cursor("t", dev, 8, launch)
        assert seen[0] == seen[1] != seen[2]
        cursor = oc._CURSORS[(dev, 7)]
        assert cursor.dtype == torch.int32
        assert cursor.tolist() == [0] * oc.CURSOR_INTS
        with pytest.raises(RuntimeError, match="cudaError 719"):
            oc.launch_on_cursor("t", dev, 7, lambda cursor: 719)
        assert (dev, 7) not in oc._CURSORS and (dev, 8) in oc._CURSORS
        oc.launch_on_cursor("t", dev, 7, launch)
        assert oc._CURSORS[(dev, 7)] is not cursor
    finally:
        for stream in (7, 8):
            oc._CURSORS.pop((dev, stream), None)
