"""Port vs the JAX package's Pallas kernels, run as its own tests run them
on the CPU (interpret mode): the port's plain sweeps (the plain versions of
kernels K1/K2) against `density_pallas` / `accel_pallas` at the twin
tolerance, and its plain rebin (the plain version of K3) against
`rebin_pallas` bitwise, under a nudge that forces overflow."""

import jax
import jax.numpy as jnp
import pytest
import torch

from sph_tpu_torch.sph import dense as tdense

from test_torch_dense import (
    CYL,
    Twin,
    assert_rebin_equal,
    assert_sweep_close,
    nudged_positions,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def twin3d():
    """3D k=8 for the Pallas interpret-mode comparisons. The port agrees
    with the JAX twin run eagerly; the jitted Pallas kernel differs from
    that eager twin by XLA's FMA contraction alone, which at n=3000 already
    reaches 1.6e-6·max|x| in accel (JAX against itself), so this size is
    n=1000, where the contract holds for JAX against itself too."""
    return Twin("dam_break_3d", dict(n_target=1000, obstacles=CYL,
                                     dense_k=8, cell_factor=1.2,
                                     use_pallas=False))


def test_sweeps_match_pallas_interpret(twin3d):
    from sph_tpu.ops.pallas.fluid import accel_pallas, density_pallas

    tw = twin3d
    rho_p = jax.jit(lambda d: density_pallas(
        d.px, d.py, d.pz, d.occ, tw.jp, tw.jspec))(tw.jd)
    rho_t = tdense.density_raw(tw.td.px, tw.td.py, tw.td.pz, tw.tp,
                               tw.tspec)
    assert_sweep_close(rho_p, rho_t.numpy(), tw.occ)

    jd, td = tw.prepared()
    a_p = jax.jit(lambda d: accel_pallas(
        d, d.prs / (d.rho * d.rho), tw.jp, tw.jspec))(jd)
    a_t = tdense.accel_pass(td, tw.tp, tw.tspec)
    for x, p in zip(a_p, a_t):
        assert_sweep_close(x, p.numpy(), tw.occ)


def test_rebin_matches_pallas_interpret(twin3d):
    from sph_tpu.ops.pallas.rebin import rebin_pallas

    tw = twin3d
    ps = nudged_positions(tw, seed=1)
    jd, td = tw.prepared()     # nonzero velocities ride along
    a = jax.jit(lambda d, px, py, pz: rebin_pallas(
        d, px, py, pz, d.vx, d.vy, d.vz, tw.jp, tw.jspec))(
        jd, *map(jnp.asarray, ps))
    b = tdense.rebin(td, *map(torch.from_numpy, ps), td.vx, td.vy, td.vz,
                     tw.tp, tw.tspec)
    assert_rebin_equal(a, b)
    assert int(b.dropped) > 0
