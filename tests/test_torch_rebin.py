"""The rebin kernel K3's algorithm on the CPU (csrc/rebin.cu: move codes,
then one ordered 27-cell walk with three counters): its plain emulation
`verify.rebin_walk` held bitwise (7 fields, −0 == +0, and `dropped`) to the
staged plain rebin `dense.rebin` and to the JAX package's `rebin_pallas` in
interpret mode — on nudged scenes, on random layouts with moves of up to
two cells (the "far" codes) and on a hand-built intermediate overflow. Also
the wrapper's refusals, which come before any launch."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sph_tpu.sph import dense as jdense
from sph_tpu_torch.ops import LAUNCHES, reset_launches
from sph_tpu_torch.ops.rebin import check_spec, halo_bytes, staged_rebin
from sph_tpu_torch.sph import dense
from sph_tpu_torch.sph.scenes import dam_break_2d, dam_break_3d_obstacle
from sph_tpu_torch.utils.verify import (
    empty_layout,
    moved_layout,
    nudge,
    overflow_layout,
    place_particle,
    rebin_codes,
    rebin_walk,
)

from test_torch_dense import CYL, Twin, assert_rebin_equal

torch.set_num_threads(1)

FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "occ")

SCENES = {
    "3d": (dam_break_3d_obstacle, dict(n_target=3000, cell_factor=1.38,
                                       dense_k=8, rebin_every=6)),
    "2d": (dam_break_2d, dict(n_target=300, dense_k=4, cell_factor=1.2,
                              rebin_every=3)),
}
# Twins (both packages) whose specs carry the layouts, at each K the
# kernel is built for.
TWINS = {
    "3d": ("dam_break_3d", dict(n_target=1000, obstacles=CYL, dense_k=8,
                                cell_factor=1.2, use_pallas=False)),
    "2d": ("dam_break_2d", dict(n_target=300, dense_k=4, cell_factor=1.2,
                                use_pallas=False)),
}
LAYOUTS = ["3d8", "3d4", "2d4", "2d8"]


class Layouts:
    """A twin's specs at K = k, and both packages' states for a layout."""

    def __init__(self, tw, k):
        self.tw, self.tp, self.jp = tw, tw.tp, tw.jp
        self.tspec = dataclasses.replace(tw.tspec, k=k)
        self.jspec = dataclasses.replace(tw.jspec, k=k)

    def states(self, lay):
        zeros = np.zeros_like(lay["occ"])
        return self.tw.with_fields(**lay, rho=zeros, prs=zeros)


@pytest.fixture(scope="module")
def twins():
    return {}


def twin(twins, name):
    """Layouts on spec `name` ("3d8": the 3D twin at K = 8, ...)."""
    scene = name[:2]
    if scene not in twins:
        twins[scene] = Twin(*TWINS[scene])
    return Layouts(twins[scene], int(name[2:]))


def assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.dropped) == int(b.dropped)


def rebin_both(d, ps, p, spec):
    args = (*ps, d.vx, d.vy, d.vz, p, spec)
    return rebin_walk(d, *args), dense.rebin(d, *args)


def torch_layout(tw, lay):
    """The torch state holding the layout, and its positions."""
    _, td = tw.states(lay)
    return td, (td.px, td.py, td.pz)


@pytest.mark.parametrize("case", sorted(SCENES))
def test_walk_matches_staged_rebin_on_nudged_scenes(case):
    scene, kw = SCENES[case]
    st, p = scene(**kw)
    spec = dense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)
    d = dense.pack(st, p, spec, device="cpu")
    for seed in (0, 1):
        walk, plain = rebin_both(d, nudge(d, spec, p, seed), p, spec)
        assert_same(walk, plain)
        assert int(plain.dropped) > 0


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_staged_rebin_on_far_moves(twins, name, seed):
    tw = twin(twins, name)
    lay = moved_layout(tw.tspec, seed)
    d, ps = torch_layout(tw, lay)
    codes = rebin_codes(*ps, d.occ, tw.tspec)
    assert bool(((codes & 3) == 3).any())          # far in-row moves occur
    walk, plain = rebin_both(d, ps, tw.tp, tw.tspec)
    assert_same(walk, plain)
    assert int(plain.dropped) > 0
    assert 0 < int(plain.occ.sum()) < int(d.occ.sum())


@pytest.mark.parametrize("name,stage", [("3d8", 2), ("3d8", 1), ("3d4", 2),
                                        ("3d4", 1), ("2d4", 2), ("2d8", 2)])
def test_walk_keeps_an_intermediate_overflow(twins, name, stage):
    tw = twin(twins, name)
    lay, (z, r, x) = overflow_layout(tw.tspec, stage)
    d, ps = torch_layout(tw, lay)
    walk, plain = rebin_both(d, ps, tw.tp, tw.tspec)
    assert_same(walk, plain)
    # One particle dropped in the intermediate stage, and its final cell
    # (empty before) stays empty: a one-stage move would have placed it.
    assert int(plain.dropped) == 1
    assert not bool(plain.occ[z, :, r * tw.tspec.X + x].any())
    assert int(plain.occ.sum()) == tw.tspec.k


@pytest.mark.parametrize("name", LAYOUTS)
def test_walk_matches_pallas_interpret(twins, name):
    """The walk against `rebin_pallas` (interpret mode) on a far-move
    layout and on the intermediate overflow."""
    from sph_tpu.ops.pallas.rebin import rebin_pallas

    tw = twin(twins, name)
    run = jax.jit(lambda d: rebin_pallas(d, d.px, d.py, d.pz, d.vx, d.vy,
                                         d.vz, tw.jp, tw.jspec))
    for lay in (moved_layout(tw.tspec, seed=5),
                overflow_layout(tw.tspec, 2)[0]):
        jd, td = tw.states(lay)
        a = run(jd)
        b = rebin_walk(td, td.px, td.py, td.pz, td.vx, td.vy, td.vz, tw.tp,
                       tw.tspec)
        assert_rebin_equal(a, b)
        assert int(a.dropped) > 0


def nan_layout(spec, far_inf: bool, seed=0):
    """ROADMAP C1's scene: the layout emptied, one particle in layout cell
    (1, 1, 1) whose world x is NaN, one in (2, 2, 2); with `far_inf`, two
    more in (5, 5, 5) and (6, 6, 6) whose y is +inf and z is −inf (each
    then bins to an edge of the interior, a far move: dropped)."""
    lay = empty_layout(spec)
    rng = np.random.default_rng(seed)
    cells = ((1, 1, 1), (2, 2, 2)) + (((5, 5, 5), (6, 6, 6)) if far_inf
                                      else ())
    for cell in cells:
        place_particle(lay, spec, 0, cell, cell, rng)
    X = spec.X
    lay["px"][1, 0, X + 1] = np.nan
    if far_inf:
        lay["py"][5, 0, 5 * X + 5] = np.inf
        lay["pz"][6, 0, 6 * X + 6] = -np.inf
    return lay


def assert_bits(got, want, where=None):
    """Equal bits on every field where `where` (default: everywhere); NaN
    counts as equal to NaN (IEEE leaves its payload open, and x86 gives a
    NaN made by arithmetic another sign than numpy's)."""
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        m = np.ones(a.shape, bool) if where is None else where
        np.testing.assert_array_equal(np.isnan(a[m]), np.isnan(b[m]),
                                      err_msg=f)
        ok = m & ~np.isnan(b)
        np.testing.assert_array_equal(a[ok].view(np.int32),
                                      b[ok].view(np.int32), err_msg=f)


@pytest.mark.parametrize("far_inf", [False, True])
def test_nan_position_rebins_as_jax(twins, far_inf):
    """A NaN coordinate bins to the interior's first cell, as XLA's
    convert (NaN → 0) and clip give it; ±inf to its edges. The port's
    plain rebin and K3's walk equal JAX's Pallas rebin (interpret mode)
    bit for bit with equal `dropped` (0 for the C1 scene). Against JAX's
    XLA twin `dense.rebin`: equal occupancy and `dropped`, and equal bits
    wherever the twin is finite — the twin's 0/1-mask compaction also
    writes NaN into the other particles of the NaN's windows
    (`_compact_stage`)."""
    from sph_tpu.ops.pallas.rebin import rebin_pallas

    tw = twin(twins, "3d8")
    jd, td = tw.states(nan_layout(tw.tspec, far_inf))
    kern = jax.jit(lambda d: rebin_pallas(d, d.px, d.py, d.pz, d.vx, d.vy,
                                          d.vz, tw.jp, tw.jspec))(jd)
    xla = jdense.rebin(jd, jd.px, jd.py, jd.pz, jd.vx, jd.vy, jd.vz,
                       tw.jp, tw.jspec)
    args = (td.px, td.py, td.pz, td.vx, td.vy, td.vz, tw.tp, tw.tspec)
    finite = np.isfinite(np.asarray(xla.px)) & np.isfinite(
        np.asarray(xla.py)) & np.isfinite(np.asarray(xla.pz))
    for got in (dense.rebin(td, *args), rebin_walk(td, *args)):
        assert_bits(got, kern)
        assert_bits(got, xla, where=finite)
        np.testing.assert_array_equal(got.occ.numpy(), np.asarray(xla.occ))
        assert int(got.dropped) == int(kern.dropped) == int(xla.dropped) \
            == (2 if far_inf else 0)
        assert int(got.occ.sum()) == 2 and bool(got.px.isnan().any())
    # The twin's NaN reached the particle in (2, 2, 2).
    assert not finite[2, 0, 2 * tw.tspec.X + 2]


def test_codes_name_each_move(twins):
    """One particle per move (−1, +1, far) along each axis of a 3D spec:
    its code byte says that move on that axis and no move on the others."""
    tw = twin(twins, "3d8")
    spec = tw.tspec
    lay = empty_layout(spec)
    rng = np.random.default_rng(0)
    z, r, x = spec.n0 // 2, spec.n1 // 2, spec.n2 // 2
    want = {}
    moves = [(dim, m) for dim in (0, 1, 2) for m in (-1, 1, 2)]
    for i, (dim, m) in enumerate(moves):
        src, slot = (z, r + i // spec.k, x), i % spec.k
        dst = list(src)
        dst[dim] += m
        place_particle(lay, spec, slot, src, tuple(dst), rng)
        e, shift = {-1: 0, 1: 2, 2: 3}[m], (4, 2, 0)[dim]
        want[(src, slot)] = 0x40 | sum((e if s == shift else 1) << s
                                       for s in (0, 2, 4))
    d, ps = torch_layout(tw, lay)
    codes = rebin_codes(*ps, d.occ, spec)
    for ((zz, rr, xx), slot), code in want.items():
        assert int(codes[zz, slot, rr * spec.X + xx]) == code
    assert int((codes != 0).sum()) == len(moves)


def test_refusals_come_before_any_launch():
    """K outside {4, 8}, a spec without a row stage and a halo past shared
    memory raise ValueError; a tensor off the CPU never takes the plain
    rebin (here a `meta` tensor: the wrapper raises before it could
    launch)."""
    scene, kw = SCENES["3d"]
    st, p = scene(**kw)
    spec = dense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)
    check_spec(spec)
    check_spec(dataclasses.replace(spec, k=4))
    for bad, match in ((dataclasses.replace(spec, k=6), "K in"),
                       (dataclasses.replace(spec, stencil1=False), "row"),
                       (dataclasses.replace(spec, n2=4800), "shared memory")):
        with pytest.raises(ValueError, match=match):
            check_spec(bad)
    # config[3]'s spec: 3 planes × (256 + 2 · 81) words of 8 bytes.
    c3 = dataclasses.replace(spec, n0=145, n1=96, n2=80, k=8)
    assert halo_bytes(c3) == 3 * (256 + 162) * 8
    d = dense.pack(st, p, spec, device="cpu")
    meta = {f: getattr(d, f).to("meta") for f in FIELDS}
    dm = d.replace_fields(**meta)
    reset_launches()
    with pytest.raises(ValueError, match="K in"):
        staged_rebin(dm, meta["px"], meta["py"], meta["pz"], meta["vx"],
                     meta["vy"], meta["vz"], p,
                     dataclasses.replace(spec, k=6))
    with pytest.raises(ValueError, match="CUDA"):
        staged_rebin(dm, meta["px"], meta["py"], meta["pz"], meta["vx"],
                     meta["vy"], meta["vz"], p, spec)
    assert LAUNCHES["rebin"] == 0
