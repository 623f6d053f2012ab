"""Port vs reference: the dense engine's plain passes (the plain versions
of kernels K1/K2/K3), the integrator and one whole step — the same numpy
inputs through sph_tpu (JAX on the CPU, its XLA twin) and sph_tpu_torch
(PyTorch on the CPU). The Pallas kernels in interpret mode are in
tests/test_torch_pallas.py.

Tolerances: the pair sweeps use the JAX twin contract, rtol 1e-5 and
atol 1e-6·max|x| on occupied slots (tests/test_dense.py); the integrator
rtol 1e-5 (XLA may contract FMAs; torch on the CPU does not); the rebin is
bitwise (pure data movement; −0 == +0, as assert_array_equal compares).
The JAX twins run eagerly (no jit): op-by-op XLA needs no whole-graph
compile, which keeps the 3D k=8 cases fast."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sph_tpu.sph import dense as jdense
from sph_tpu.sph import model as jmodel
from sph_tpu.sph import scenes as jscenes
from sph_tpu_torch.ops import fluid
from sph_tpu_torch.sph import dense as tdense
from sph_tpu_torch.sph import model as tmodel
from sph_tpu_torch.sph import scenes as tscenes

torch.set_num_threads(1)

CYL = (("cylinder_z", (0.3, 0.4), 0.1),)
CASES = {
    "2d": ("dam_break_2d", dict(n_target=300, dense_k=4, cell_factor=1.2,
                                use_pallas=False)),
    "3d": ("dam_break_3d", dict(n_target=3000, obstacles=CYL, dense_k=8,
                                cell_factor=1.2, use_pallas=False)),
}


class Twin:
    """One scene packed in both packages from the same numpy lattice."""

    def __init__(self, scene, kw):
        st_j, self.jp = getattr(jscenes, scene)(**kw)
        st_t, self.tp = getattr(tscenes, scene)(**kw)
        k, cf = self.jp.dense_k, self.jp.cell_factor
        self.jspec = jdense.make_dense_spec(self.jp, k=k, cell_factor=cf)
        self.tspec = tdense.make_dense_spec(self.tp, k=k, cell_factor=cf)
        self.jd = jdense.pack(st_j, self.jp, self.jspec)
        self.td = tdense.pack(st_t, self.tp, self.tspec, device="cpu")
        self.occ = np.asarray(self.jd.occ) > 0.5

    def with_fields(self, **arrays):
        """Both states with the given numpy fields replaced."""
        jd = self.jd.replace_fields(
            **{k: jnp.asarray(v) for k, v in arrays.items()})
        td = self.td.replace_fields(
            **{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
        return jd, td

    def prepared(self):
        """States with ρ, p from the JAX twin and a nonzero velocity field
        (viscosity terms then matter), identical in both packages."""
        rho = np.asarray(jdense.density_pass(self.jd, self.jp, self.jspec))
        prs = np.asarray(jnp.where(self.jd.occ > 0.5,
                                   jmodel.eos_pressure(rho, self.jp), 0.0))
        px, py = np.asarray(self.jd.px), np.asarray(self.jd.py)
        occ = np.asarray(self.jd.occ)
        return self.with_fields(
            rho=rho, prs=prs,
            vx=(np.sin(px * 3) * occ).astype(np.float32),
            vy=(np.cos(py * 3) * occ).astype(np.float32),
        )


@pytest.fixture(scope="module", params=sorted(CASES))
def twin(request):
    return Twin(*CASES[request.param])


def assert_sweep_close(x, p, occ):
    """The JAX twin contract on occupied slots."""
    x = np.asarray(x)[occ]
    p = np.asarray(p)[occ]
    np.testing.assert_allclose(p, x, rtol=1e-5,
                               atol=1e-6 * np.abs(x).max())


def nudged_positions(tw, seed=0):
    """Random scatter plus a pull toward the domain centre (clamped to the
    0.9-cell reachability budget per axis): cells crowd past K, so the
    rebin's overflow path runs (tests/test_dense.py)."""
    rng = np.random.default_rng(seed)
    lim = 0.9 * tw.jspec.cell
    delta = rng.uniform(-lim, lim, (3, *tw.occ.shape)).astype(np.float32)
    out = []
    for a, f in enumerate(("px", "py", "pz")):
        p = np.asarray(getattr(tw.jd, f))
        ctr = (tw.jp.bounds_min[a] + tw.jp.bounds_max[a]) / 2
        moved = p + np.float32(0.3) * delta[a] + np.clip(
            np.float32(ctr) - p, -lim, lim)
        out.append(np.where(tw.occ, moved, p).astype(np.float32))
    return out


def assert_rebin_equal(a, b):
    for f in ("occ", "px", "py", "pz", "vx", "vy", "vz"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
    assert int(a.dropped) == int(b.dropped)


def test_density_pass_matches_jax_twin(twin):
    rho_j = jdense.density_pass(twin.jd, twin.jp, twin.jspec)
    rho_t = tdense.density_pass(twin.td, twin.tp, twin.tspec)
    assert rho_t.dtype == torch.float32
    assert_sweep_close(rho_j, rho_t.numpy(), twin.occ)
    # Empty lanes carry the rest density in both.
    np.testing.assert_array_equal(rho_t.numpy()[~twin.occ],
                                  np.asarray(rho_j)[~twin.occ])


def test_accel_pass_matches_jax_twin(twin):
    jd, td = twin.prepared()
    a_j = jdense.accel_pass(jd, twin.jp, twin.jspec)
    a_t = tdense.accel_pass(td, twin.tp, twin.tspec)
    assert np.abs(np.asarray(a_j[0])[twin.occ]).max() > 0
    for x, p in zip(a_j, a_t):
        assert_sweep_close(x, p.numpy(), twin.occ)


def test_rebin_matches_jax_twin(twin):
    ps = nudged_positions(twin)
    a = jdense.rebin(twin.jd, *map(jnp.asarray, ps), twin.jd.vx,
                     twin.jd.vy, twin.jd.vz, twin.jp, twin.jspec)
    b = tdense.rebin(twin.td, *map(torch.from_numpy, ps), twin.td.vx,
                     twin.td.vy, twin.td.vz, twin.tp, twin.tspec)
    assert_rebin_equal(a, b)
    assert int(b.dropped) > 0       # the nudge exercised overflow
    assert b.dropped.dtype == torch.int32


def _screened(pair_fn, survives):
    """pair_fn with every term forced to +0 where `survives` is False."""
    def f(*a):
        keep = survives(*a)
        return tuple(torch.where(keep, t, 0.0) for t in pair_fn(*a))
    return f


def _r2(cx, cy, cz, qx, qy, qz):
    dx, dy, dz = cx - qx, cy - qy, cz - qz
    return dx * dx + dy * dy + dz * dz


def test_screen_is_bitwise_invisible(twin):
    """The K1/K2 partner screen (csrc/fluid_sweep.cu) on the plain sweep:
    forcing to +0 every term the kernel skips — K1 where h² − r² ≤ 0; K2
    where its first pass drops the partner (r2_cut < r² < +inf) or where
    h − r ≤ 0 with r = r²·rsqrt(max(r², 1e-18)) — leaves every slot's bits
    as the unscreened sweep's, for density and accel."""
    td, p, spec = twin.td, twin.tp, twin.tspec
    h2 = p.h * p.h

    def density(pair):
        accs, m_row, m_cs = tdense._sweep_plain(
            (td.px, td.py, td.pz), pair, ncomp=1,
            self_init=tdense.density_self_term(p), spec=spec, sign=1)
        return [tdense.combine_mirror_parts(
            accs[0], m_row[0] if m_row else None, [m[0] for m in m_cs],
            spec, sign=1)]

    def d_pair(*a):
        return tdense.density_pair_term(h2, *a)

    full = density(d_pair)
    skipped = density(_screened(
        d_pair, lambda *a: ~((h2 - _r2(*a)) <= 0)))

    rho = tdense.density_pass(td, p, spec)
    occ = td.occ
    d = td.replace_fields(
        rho=rho, prs=torch.where(occ > 0.5, tmodel.eos_pressure(rho, p), 0.0),
        vx=torch.sin(td.px * 3) * occ, vy=torch.cos(td.py * 3) * occ)
    pr2, irho = d.prs / (d.rho * d.rho), torch.reciprocal(d.rho)
    h, neg_m_spiky, visc_mc = tdense.accel_constants(p)

    def accel(pair):
        fields = (d.px, d.py, d.pz, d.vx, d.vy, d.vz, irho, pr2)
        accs, m_row, m_cs = tdense._sweep_plain(
            fields, pair, ncomp=3, self_init=None, spec=spec, sign=-1)
        return [tdense.combine_mirror_parts(
            accs[c], m_row[c] if m_row else None, [ms[c] for ms in m_cs],
            spec, sign=-1) for c in range(3)]

    def a_pair(*a):
        return tdense.accel_pair_terms(h, neg_m_spiky, visc_mc, *a)

    cut = fluid.accel_r2_cut(h)

    def a_survives(*a):
        r2 = _r2(*a[:3], *a[8:11])
        marked = ~((r2 > cut) & (r2 < float("inf")))
        r = r2 * torch.rsqrt(torch.clamp_min(r2, 1e-18))
        return marked & ~((h - r) <= 0)

    full += accel(a_pair)
    skipped += accel(_screened(a_pair, a_survives))
    for a, b in zip(full, skipped):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((full[1] != 0).any())       # the accel terms were exercised
    # The screen did skip: most stencil partners lie outside h.
    r2 = _r2(td.px, td.py, td.pz, *(torch.roll(f, (0, 0, 1), (0, 1, 2))
                                    for f in (td.px, td.py, td.pz)))
    assert bool(((h2 - r2) <= 0)[occ > 0.5].any())


def _ulps_around(x, n):
    """x and its n f32 neighbours on each side."""
    out, up, down = [x], x, x
    for _ in range(n):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(0))
        out += [up, down]
    return out


@settings(max_examples=400, deadline=None)
@given(h=st.floats(1e-4, 10.0), above=st.integers(1, 1 << 16))
def test_accel_r2_cut_never_drops_a_live_pair(h, above):
    """K2's first pass drops a partner when r² > r2_cut. For every f32 r²
    above the cut and every rsqrt within the card's 2 ulp of 1/√r²,
    r = r²·rsqrt rounds to r ≥ h, so h − r ≤ 0: the exact screen of the
    second pass would drop the pair too. And the cut is only just above
    h² (a margin of 2⁻¹⁶, rounded up to f32)."""
    hf = np.float32(h)
    cut = np.float32(fluid.accel_r2_cut(h))
    assert float(cut) >= float(hf) ** 2 * (1 + fluid.R2_CUT_MARGIN)
    assert cut <= np.float32(hf * hf) * np.float32(1 + 2 * fluid.R2_CUT_MARGIN)
    r2 = (np.array([cut]).view(np.int32) + above).view(np.float32)[0]
    exact = np.float32(1.0 / np.sqrt(np.float64(r2)))
    for rinv in _ulps_around(exact, 2):
        r = np.float32(r2 * rinv)
        assert np.float32(hf - r) <= 0, (h, r2, rinv)


def test_integrate_with_obstacle_and_drag():
    tw = Twin(*CASES["3d"])
    jd, td = tw.prepared()
    rng = np.random.default_rng(3)
    acc = [rng.normal(0, 50.0, tw.occ.shape).astype(np.float32)
           for _ in range(3)]
    centre = np.asarray(tw.td.px).reshape(-1)[tw.occ.reshape(-1)][0]
    ctr = (float(centre), 0.2, 0.3)
    drag_j = jmodel.FluidDrag.at(ctr, (0.5, 0.5, 0.5), 0.15, 3000.0)
    drag_t = tmodel.FluidDrag.at(ctr, (0.5, 0.5, 0.5), 0.15, 3000.0,
                                 device="cpu")
    vmax = jdense.rebin_vmax(tw.jp, tw.jspec)
    assert vmax == tdense.rebin_vmax(tw.tp, tw.tspec)
    out_j = jdense._integrate(jd, *map(jnp.asarray, acc), tw.jp, vmax,
                              drag=drag_j)
    out_t = tdense._integrate(td, *map(torch.from_numpy, acc), tw.tp, vmax,
                              drag=drag_t)
    for x, p in zip(out_j[:6], out_t[:6]):
        np.testing.assert_allclose(p.numpy(), np.asarray(x), rtol=1e-5)
    assert int(out_j[6]) == int(out_t[6]) > 0     # the clamp fired
    assert out_t[6].dtype == torch.int32


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_step_matches_jax(case):
    """One step from identical inputs, with a rebin: ρ and p at the twin
    tolerance; the rebin bitwise when fed the JAX step's own integrate
    outputs (a particle within an ulp of a cell edge may bin differently
    from an ulp-different position, so the end state is compared through
    the rebin on identical inputs)."""
    scene, kw = CASES[case]
    tw = Twin(scene, dict(kw, rebin_every=1))
    jp, jspec = tw.jp, tw.jspec
    d1 = jdense.dense_step(tw.jd, jp, jspec)
    t1 = tdense.dense_step(tw.td, tw.tp, tw.tspec)
    assert_sweep_close(d1.rho, t1.rho.numpy(), tw.occ)
    np.testing.assert_allclose(t1.prs.numpy()[tw.occ],
                               np.asarray(d1.prs)[tw.occ], rtol=1e-5,
                               atol=1e-6 * jp.tait_b)
    assert int(t1.step_count) == int(d1.step_count) == 1
    assert int(t1.clamped) == int(d1.clamped)

    # JAX's pre-rebin fields, recomputed eagerly exactly as its step does.
    rho = jdense.density_pass(tw.jd, jp, jspec)
    prs = jnp.where(tw.jd.occ > 0.5, jmodel.eos_pressure(rho, jp), 0.0)
    jd = tw.jd.replace_fields(rho=rho, prs=prs)
    ax, ay, az = jdense.accel_pass(jd, jp, jspec)
    moved = jdense._integrate(jd, ax, ay, az, jp,
                              jdense.rebin_vmax(jp, jspec))[:6]
    td = tw.td.replace_fields(rho=t1.rho, prs=t1.prs)
    b = tdense.rebin(td, *(torch.from_numpy(np.array(m)) for m in moved),
                     tw.tp, tw.tspec)
    assert_rebin_equal(d1, b)

    # Without a rebin the moved fields agree at the integrator tolerance.
    t0 = tdense.dense_step(tw.td, tw.tp, tw.tspec, rebin_now=False)
    for f, m in zip(("px", "py", "pz", "vx", "vy", "vz"), moved):
        np.testing.assert_allclose(getattr(t0, f).numpy(), np.asarray(m),
                                   rtol=1e-5, err_msg=f)


def test_substep_loop_rebins_on_cadence():
    """make_dense_step decides the rebin from the host step index exactly
    as dense_step does from step_count (step % R == R − 1)."""
    tw = Twin(*CASES["2d"])
    p = dataclasses.replace(tw.tp, rebin_every=3)
    assert [tdense.is_rebin_step(s, p) for s in range(6)] == [
        False, False, True, False, False, True]
    f = tdense.make_dense_step(p, tw.tspec, substeps=7)
    a = f(tw.td, 0)
    b = tw.td
    for _ in range(7):
        b = tdense.dense_step(b, p, tw.tspec)     # reads step_count
    for fld in dataclasses.fields(a):
        assert torch.equal(getattr(a, fld.name), getattr(b, fld.name))
    assert int(a.step_count) == 7
    with pytest.raises(ValueError, match="cell_factor"):
        tdense.make_dense_step(
            p, dataclasses.replace(tw.tspec, cell=p.h), substeps=1)
