"""Port vs reference: smoothing kernels, EOS, SDF obstacles, walls, scenes,
the dense spec and pack — the same numpy inputs through sph_tpu (JAX, CPU)
and sph_tpu_torch (PyTorch, CPU).

Tolerances: scenes, spec and pack are bitwise (pure numpy / data
movement); the elementwise model functions are held to rtol 1e-6 (f32
transcendental and sqrt rounding may differ by an ulp between backends)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.sph import dense as jdense
from sph_tpu.sph import kernels as jkern
from sph_tpu.sph import model as jmodel
from sph_tpu.sph import scenes as jscenes
from sph_tpu_torch.sph import dense as tdense
from sph_tpu_torch.sph import kernels as tkern
from sph_tpu_torch.sph import model as tmodel
from sph_tpu_torch.sph import scenes as tscenes

torch.set_num_threads(1)

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("ndim", [2, 3])
def test_kernel_coefficients_and_functions(ndim):
    h = 0.0123
    for name in ("poly6_coeff", "spiky_grad_coeff", "viscosity_lap_coeff"):
        assert getattr(tkern, name)(h, ndim) == float(
            getattr(jkern, name)(h, ndim)), name
    rng = np.random.default_rng(ndim)
    r_vec = rng.uniform(-h, h, (500, 3)).astype(np.float32)
    r2 = np.sum(r_vec * r_vec, -1).astype(np.float32)
    r = np.sqrt(r2).astype(np.float32)
    np.testing.assert_allclose(
        tkern.w_poly6(_t(r2), h, ndim).numpy(),
        np.asarray(jkern.w_poly6(jnp.asarray(r2), h, ndim)), rtol=RTOL)
    np.testing.assert_allclose(
        tkern.grad_w_spiky(_t(r_vec), _t(r), h, ndim).numpy(),
        np.asarray(jkern.grad_w_spiky(jnp.asarray(r_vec), jnp.asarray(r),
                                      h, ndim)), rtol=RTOL)
    np.testing.assert_allclose(
        tkern.lap_w_viscosity(_t(r), h, ndim).numpy(),
        np.asarray(jkern.lap_w_viscosity(jnp.asarray(r), h, ndim)),
        rtol=RTOL)


def test_eos_pressure():
    """rtol 1e-6 plus atol 1e-6·B: `** 7` may round its last ulp
    differently per backend (JAX's own jit and eager paths differ), and
    the `− 1` turns that ulp into a large relative error near rest
    density; 1e-6·B bounds it in pressure units."""
    rng = np.random.default_rng(0)
    rho = rng.uniform(700.0, 1600.0, 4000).astype(np.float32)
    jp = jmodel.SPHParams(sound_speed=60.0)
    tp = tmodel.SPHParams(sound_speed=60.0)
    a = tmodel.eos_pressure(_t(rho), tp).numpy()
    b = np.asarray(jmodel.eos_pressure(jnp.asarray(rho), jp))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6 * jp.tait_b)
    assert (a[rho < 1000.0] == 0).all() and (a[rho > 1001.0] > 0).all()


@pytest.mark.parametrize("obstacle", [
    ("sphere", (0.5, 0.4, 0.5), 0.2),
    ("box", (0.5, 0.5, 0.4), (0.2, 0.1, 0.3)),
    ("cylinder_z", (0.45, 0.55), 0.15),
])
def test_obstacle_accel(obstacle):
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.0, 1.0, (4000, 3)).astype(np.float32)
    kw = dict(h=0.05, obstacles=(obstacle,))
    a = tmodel.obstacle_accel(_t(pos), tmodel.SPHParams(**kw)).numpy()
    b = np.asarray(jmodel.obstacle_accel(jnp.asarray(pos),
                                         jmodel.SPHParams(**kw)))
    assert np.abs(b).max() > 0          # the obstacle actually pushes
    np.testing.assert_allclose(a, b, rtol=RTOL)
    sd_t, n_t = tmodel.sdf_value_grad(_t(pos), obstacle)
    sd_j, n_j = jmodel.sdf_value_grad(jnp.asarray(pos), obstacle)
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("ndim", [2, 3])
def test_apply_boundaries_bitwise(ndim):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-0.2, 1.2, (1000, 3)).astype(np.float32)
    vel = rng.normal(size=(1000, 3)).astype(np.float32)
    p_t, v_t = tmodel.apply_boundaries(
        _t(pos), _t(vel), tmodel.SPHParams(ndim=ndim))
    p_j, v_j = jmodel.apply_boundaries(
        jnp.asarray(pos), jnp.asarray(vel), jmodel.SPHParams(ndim=ndim))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


SCENES = [
    ("dam_break_2d", dict(n_target=300)),
    ("splash_pour_2d", dict(n_target=500)),
    ("dam_break_3d", dict(n_target=3000)),
    ("dam_break_3d_obstacle", dict(n_target=3000, dense_k=8,
                                   cell_factor=1.38, rebin_every=6)),
]


@pytest.mark.parametrize("scene,kw", SCENES, ids=[s for s, _ in SCENES])
def test_scenes_bitwise(scene, kw):
    st_t, p_t = getattr(tscenes, scene)(**kw)
    st_j, p_j = getattr(jscenes, scene)(**kw)
    assert dataclasses.asdict(p_t) == dataclasses.asdict(p_j)
    for f in ("pos", "vel", "density", "pressure", "step_count",
              "bin_overflow"):
        np.testing.assert_array_equal(
            getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f)),
            err_msg=f)
    assert st_t.pos.dtype == torch.float32
    assert st_t.step_count.dtype == torch.int32


PACKS = [
    ("dam_break_2d", dict(n_target=300, dense_k=4, cell_factor=1.2)),
    ("dam_break_3d_obstacle", dict(n_target=3000, dense_k=8,
                                   cell_factor=1.2)),
]


@pytest.mark.parametrize("scene,kw", PACKS, ids=[s for s, _ in PACKS])
def test_spec_pack_unpack_bitwise(scene, kw):
    st_t, p_t = getattr(tscenes, scene)(**kw)
    st_j, p_j = getattr(jscenes, scene)(**kw)
    spec_t = tdense.make_dense_spec(p_t, k=p_t.dense_k,
                                    cell_factor=p_t.cell_factor)
    spec_j = jdense.make_dense_spec(p_j, k=p_j.dense_k,
                                    cell_factor=p_j.cell_factor)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    d_t = tdense.pack(st_t, p_t, spec_t, device="cpu")
    d_j = jdense.pack(st_j, p_j, spec_j)
    for f in dataclasses.fields(d_t):
        a, b = getattr(d_t, f.name).numpy(), np.asarray(getattr(d_j, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for a, b in zip(tdense.unpack(d_t), jdense.unpack(d_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pack_overflow_raises():
    st, p = tscenes.dam_break_3d(n_target=3000, dense_k=2, cell_factor=1.2)
    spec = tdense.make_dense_spec(p, k=2, cell_factor=1.2)
    with pytest.raises(ValueError, match="pack overflow"):
        tdense.pack(st, p, spec, device="cpu")
