"""K4's floor modes (sph_tpu_torch/ops/contact_floor.py) against the stub
kernels they port: `zero_kernel`, `pads_kernel` and `screen_kernel` of
tools/probe_kernel_floor.py, swapped into
`sph_tpu.ops.pallas.contact._contact_kernel` as that probe swaps them and
run through `contact_sweep_pallas` in interpret mode (its choice off a
TPU).

The probe runs a 102,400-cell colony when it is imported, so it is not:
the three functions are taken from its source with `ast` and run with
`jnp` and `pl` in scope.

Tolerances: the zero and pads stubs are held bitwise (the pads sum adds
the same f32 values in the same order from +0, and f32(1e-37) times it is
one rounding), except where the port's pads result is subnormal: XLA on
the CPU flushes subnormal results to zero, the port (and the kernel, built
without fast math) keeps them, so there JAX's value is the zero of the
same sign, |difference| < 2**-126 (measured: 1 slot of the compressed
pack, −1.014519e-39 against −0); the screen stub to the twin
tolerance, rtol 1e-5 and atol 1e-6·max|x| (XLA's rsqrt and FMA contraction
differ from PyTorch's on the CPU), with every tile's hit equal. Packs: a
settled 512-cell bonded colony and the same colony compressed ×0.7
(`verify.compressed`), so that some tiles hit; at the Pallas kernel's own
row block YB and at YB forced to 8 (several gate tiles a plane).
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sph_tpu.ops.pallas.contact as pc
from sph_tpu.core import types as jtypes
from sph_tpu.physics import contact_dense as jcd
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.ops import FLOOR_LAUNCHES, reset_launches
from sph_tpu_torch.ops import contact_floor as cf
from sph_tpu_torch.ops.contact import band_plan, contact_sweep
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.utils.verify import compressed

torch.set_num_threads(1)

PROBE = Path(__file__).resolve().parents[1] / "tools" / "probe_kernel_floor.py"
STUB_OF = {"zero": "zero_kernel", "pads": "pads_kernel",
           "screen": "screen_kernel"}
RTOL = 1e-5
ATOL_REL = 1e-6


def probe_stubs() -> dict:
    """The probe's three stub kernels, executed from its source alone."""
    tree = ast.parse(PROBE.read_text())
    scope = {"jnp": jnp, "pl": pl}
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in STUB_OF.values()]
    assert len(defs) == 3
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(PROBE), "exec"),
         scope)
    return {mode: scope[name] for mode, name in STUB_OF.items()}


STUBS = probe_stubs()


@pytest.fixture(scope="module")
def packs():
    """(name → (fields, occ)), params, spec and JAX's spec and params."""
    state, params, _ = bonded_colony(512, device="cpu", dense_k=2,
                                     max_splits_per_step=8, use_pallas=True)
    spec = cd.make_contact_spec(params, k=params.dense_k,
                                cell_factor=params.dense_cell_factor)
    out = {}
    for name, st in (("settled", state),
                     ("compressed", compressed(state, 0.7))):
        fields, occ, _, _ = cd._pack_args(st, spec)
        out[name] = (fields, occ)
    jspec = jcd.ContactSpec(**dataclasses.asdict(spec))
    jparams = jtypes.SimParams(**dataclasses.asdict(params))
    return out, params, spec, jspec, jparams


def jax_stub(mode, fields, occ, jspec, jparams, yb, monkeypatch):
    """The probe's stub `mode` through contact_sweep_pallas (interpret
    mode) at row block `yb`: 6 numpy planes."""
    monkeypatch.setattr(pc, "_contact_kernel", STUBS[mode])
    monkeypatch.setattr(pc, "_pick_yb", lambda *a: yb)
    outs = pc.contact_sweep_pallas(
        tuple(jnp.asarray(f.numpy()) for f in fields),
        jnp.asarray(occ.numpy()), jspec,
        lambda *a: jcd.contact_pair_terms(jparams, *a), ncomp=6,
        screen_fn=lambda *a: jcd.contact_screen(jparams, *a))
    return [np.asarray(o) for o in outs]


def tile_hits(x, yb):
    """[Z, Y/yb] bool: the tiles whose out0 holds a margin (any nonzero)."""
    Z, Y, L = x.shape
    return (x.reshape(Z, Y // yb, yb * L) != 0).any(axis=2)


@pytest.mark.parametrize("forced", [False, True], ids=["yb", "yb8"])
@pytest.mark.parametrize("pack", ["settled", "compressed"])
@pytest.mark.parametrize("mode", ["zero", "pads", "screen"])
def test_plain_matches_probe_stub(packs, monkeypatch, mode, pack, forced):
    byname, params, spec, jspec, jparams = packs
    fields, occ = byname[pack]
    yb = 8 if forced else pc._pick_yb(jspec, 10, 6)
    assert spec.ny % yb == 0 and (yb == 8 or yb == spec.ny)
    want = jax_stub(mode, fields, occ, jspec, jparams, yb, monkeypatch)
    got = [o.numpy() for o in cf.PLAIN[mode](fields, occ, params, spec, yb)]
    for c in range(1, 6):
        assert not got[c].view(np.int32).any() and not want[c].any()
    g, w = got[0], want[0]
    if mode == "screen":
        np.testing.assert_array_equal(tile_hits(g, yb), tile_hits(w, yb))
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL_REL * float(np.abs(w).max()))
        hits = int(tile_hits(w, yb).sum())
        assert (hits > 0) == (pack == "compressed")
    else:
        # Bitwise (−0 included) where the port's value is not subnormal;
        # XLA's flushed zero of the same sign where it is.
        sub = (g != 0) & (np.abs(g) < np.finfo(np.float32).tiny)
        flushed = np.where(sub, np.copysign(np.float32(0), g), g)
        np.testing.assert_array_equal(flushed.view(np.int32),
                                      w.view(np.int32))
    if mode == "pads":
        assert (g != 0).any() and (np.abs(g[g != 0]) < 1e-20).all()


def per_tile(full, occ, tile_rows, hit=None):
    """The stub's out0 tile by tile: `full` where the tile holds an
    occupied slot (and its max margin is > 0, for the screen), else 0."""
    out = np.zeros_like(full)
    Z, Y, _ = full.shape
    for z in range(Z):
        for y0 in range(0, Y, tile_rows):
            t = slice(y0, min(y0 + tile_rows, Y))
            gated = (occ[z, t] > 0.5).any()
            if gated and (hit is None or full[z, t].max() > 0):
                out[z, t] = full[z, t]
    return out


@pytest.mark.parametrize("tile_rows", [5, 7])
def test_plain_tiles_that_do_not_divide_the_plane(packs, tile_rows):
    """A tile_rows that does not divide Y (24): the last tile of each plane
    is shorter, and it gates and hits on its own rows."""
    byname, params, spec, _, _ = packs
    fields, occ = byname["compressed"]
    assert spec.ny % tile_rows
    o = occ.numpy()
    scale = np.float32(1e-37)
    acc = np.zeros_like(o)
    for f in fields:
        for dz in (-1, 0, 1):
            acc = acc + np.roll(f.numpy(), -dz, 0)
    pads = cf.pads_plain(fields, occ, params, spec, tile_rows)[0].numpy()
    want = per_tile(acc * scale, o, tile_rows)
    np.testing.assert_array_equal(pads.view(np.int32), want.view(np.int32))
    margin = cf.screen_margin(fields, params, spec).numpy()
    screen = cf.screen_plain(fields, occ, params, spec, tile_rows)[0].numpy()
    want = per_tile(margin, o, tile_rows, hit=True)
    np.testing.assert_array_equal(screen, want)
    assert (screen > 0).any() and (screen == 0).any()


def test_screen_keeps_nan(packs, monkeypatch):
    """A NaN radius makes NaN margins; a tile whose max margin is NaN does
    not hit (NaN > 0 is false), as jnp.max and the kernel's block max
    keep NaN — as the probe's stub does."""
    byname, params, spec, jspec, jparams = packs
    fields, occ = byname["compressed"]
    margin = cf.screen_margin(fields, params, spec)
    z, y, l = (int(i) for i in torch.nonzero(margin > 0)[0])
    rad = fields[9].clone()
    rad[z, y, l] = float("nan")
    nan_fields = (*fields[:9], rad)
    out = cf.screen_plain(nan_fields, occ, params, spec, 8)[0]
    assert bool(cf.screen_margin(nan_fields, params, spec)[z, y, l].isnan())
    t = slice(y // 8 * 8, y // 8 * 8 + 8)
    assert not bool(out[z, t].view(torch.int32).any())
    assert bool(cf.screen_plain(fields, occ, params, spec, 8)[0][z, t]
                .ne(0).any())
    want = jax_stub("screen", nan_fields, occ, jspec, jparams, 8,
                    monkeypatch)[0]
    np.testing.assert_array_equal(tile_hits(out.numpy(), 8),
                                  tile_hits(want, 8))
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", cf.MODES)
def test_wrapper_on_the_cpu(packs, mode):
    """The wrapper on CPU tensors: the plain version at the band plan's
    rows ("full": contact_sweep, bitwise), no launch counted."""
    byname, params, spec, _, _ = packs
    fields, occ = byname["compressed"]
    reset_launches()
    got = cf.contact_floor(fields, occ, params, spec, mode)
    if mode == "full":
        want = contact_sweep(fields, occ, params, spec)
        assert any(bool(w.ne(0).any()) for w in want)
    else:
        want = cf.PLAIN[mode](fields, occ, params, spec,
                              band_plan(spec).rows)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rows = cf.contact_floor(fields, occ, params, spec, mode, rows=5)
    if mode != "full":
        for a, b in zip(rows, cf.PLAIN[mode](fields, occ, params, spec, 5)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not any(FLOOR_LAUNCHES.values())


def test_wrapper_refuses_an_unknown_mode(packs):
    byname, params, spec, _, _ = packs
    fields, occ = byname["settled"]
    with pytest.raises(ValueError, match="mode"):
        cf.contact_floor(fields, occ, params, spec, "pairs")
