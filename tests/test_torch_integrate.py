"""Port vs reference: the dense step's per-slot tail, the plain versions of
the kernels F1 (`_integrate`) and F2 (the density fixup, the Tait EOS and
p/ρ²) — the same numpy inputs through sph_tpu (JAX on the CPU, eagerly)
and sph_tpu_torch (PyTorch on the CPU). The kernels themselves are held
bitwise to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: the integrator rtol 1e-5 (tests/test_torch_dense.py) with the
clamp counts equal; the density tail the twin tolerance of one dense step,
rtol 1e-5 and atol 1e-6·B for p (B the Tait stiffness; f32 pow differs in
its last ulp between backends, amplified by the − 1) and atol 1e-6·B/ρ₀²
for p/ρ² (p > 0 only where ρ > ρ₀)."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.sph import dense as jdense
from sph_tpu.sph import model as jmodel
from sph_tpu_torch.ops import LAUNCHES, build, reset_launches
from sph_tpu_torch.ops import integrate as oi
from sph_tpu_torch.sph import dense as tdense
from sph_tpu_torch.sph import model as tmodel

torch.set_num_threads(1)

SHAPE = (3, 4, 84)      # [Z, K, C]: 1,008 slots
OBSTACLES = {
    "sphere": ("sphere", (0.5, 0.4, 0.5), 0.2),
    "box": ("box", (0.5, 0.3, 0.45), (0.2, 0.1, 0.15)),
    "cylinder_z": ("cylinder_z", (0.45, 0.35), 0.15),
}
VMAX = 2.0
DRAG = dict(center=(0.5, 0.4, 0.5), target=(0.6, 0.7, 0.4), radius=0.3,
            strength=3000.0)
FIELDS = ("px", "py", "pz", "vx", "vy", "vz")


def fields(seed: int, ndim: int) -> dict:
    """A random [Z, K, C] state: 60% of slots occupied, positions over the
    tank and a little past its walls (so the walls fire), velocities of
    order 1, accelerations of order 50 with every 5th slot kicked 2,000×
    (so the vmax clamp fires); z = 0 in 2D."""
    rng = np.random.default_rng(seed)
    f = {"occ": (rng.random(SHAPE) < 0.6).astype(np.float32)}
    for i, name in enumerate(FIELDS):
        lo, hi = (-0.05, 1.05) if i < 3 else (-1.0, 1.0)
        f[name] = rng.uniform(lo, hi, SHAPE).astype(np.float32)
    kick = np.where(np.arange(f["occ"].size).reshape(SHAPE) % 5 == 0,
                    2000.0, 1.0)
    for a in ("ax", "ay", "az"):
        f[a] = (rng.normal(0.0, 50.0, SHAPE) * kick).astype(np.float32)
    if ndim == 2:
        f["pz"][:] = 0.0
        f["vz"][:] = 0.0
    return f


def params_pair(ndim: int, obstacle: str | None):
    kw = dict(ndim=ndim, obstacles=((OBSTACLES[obstacle],) if obstacle
                                    else ()))
    return jmodel.SPHParams(**kw), tmodel.SPHParams(**kw)


def states(f: dict):
    """The fields as a JAX and a torch DenseFluidState."""
    zero = np.zeros(SHAPE, np.float32)
    arrays = {k: f[k] for k in (*FIELDS, "occ")}
    j = jdense.DenseFluidState(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        rho=jnp.asarray(zero), prs=jnp.asarray(zero),
        dropped=jnp.int32(0), clamped=jnp.int32(0), step_count=jnp.int32(0))
    i32 = torch.zeros((), dtype=torch.int32)
    t = tdense.DenseFluidState(
        **{k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
        rho=torch.from_numpy(zero.copy()), prs=torch.from_numpy(zero.copy()),
        dropped=i32, clamped=i32.clone(), step_count=i32.clone())
    return j, t


def drags(on: bool):
    if not on:
        return None, None
    args = (DRAG["center"], DRAG["target"], DRAG["radius"],
            DRAG["strength"])
    return jmodel.FluidDrag.at(*args), tmodel.FluidDrag.at(*args,
                                                           device="cpu")


CASES = [(ndim, ob, drag) for ndim in (3, 2)
         for ob in ("sphere", "box", "cylinder_z") for drag in (False, True)]


@pytest.mark.parametrize("ndim,obstacle,drag", CASES)
def test_integrate_matches_jax(ndim, obstacle, drag):
    f = fields(seed=ndim * 10 + len(obstacle) + drag, ndim=ndim)
    jp, tp = params_pair(ndim, obstacle)
    jd, td = states(f)
    jdrag, tdrag = drags(drag)
    acc = [f[a] for a in ("ax", "ay", "az")]
    out_j = jdense._integrate(jd, *map(jnp.asarray, acc), jp, VMAX,
                              drag=jdrag)
    out_t = tdense._integrate(td, *map(torch.from_numpy, acc), tp, VMAX,
                              drag=tdrag)
    for name, x, p in zip(FIELDS, out_j[:6], out_t[:6]):
        np.testing.assert_allclose(p.numpy(), np.asarray(x), rtol=1e-5,
                                   err_msg=name)
    assert int(out_j[6]) == int(out_t[6]) > 0     # the clamp fired
    assert out_t[6].dtype == torch.int32 and out_t[6].dim() == 0
    occ = f["occ"] > 0.5
    walls = np.asarray(out_j[0])[occ]
    assert (walls == 0.0).any() and (walls == 1.0).any()   # walls fired
    if ndim == 2:
        assert not np.asarray(out_t[5]).any()      # vz = vz·0


def test_obstacles_push_inside_only_the_boundary_layer():
    """The penalty of each kind is zero away from the obstacle and points
    outward inside it, in both packages (a check that the cases above
    exercise the obstacle term at all)."""
    for name, ob in OBSTACLES.items():
        jp, tp = params_pair(3, name)
        centre = list(ob[1]) + [0.5] * (3 - len(ob[1]))
        pos = np.array([centre, [0.95, 0.95, 0.95]], np.float32)
        pos[0, 0] += 0.19               # inside, or in the layer of h/2
        a_j = np.asarray(jmodel.obstacle_accel(jnp.asarray(pos), jp))
        a_t = tmodel.obstacle_accel(torch.from_numpy(pos), tp).numpy()
        np.testing.assert_allclose(a_t, a_j, rtol=1e-5)
        assert a_t[0, 0] > 0 and not a_t[1].any(), name


@pytest.mark.parametrize("seed", [0, 1])
def test_density_tail_matches_jax(seed):
    """F2's plain version against the lines of JAX's dense_step between
    its sweeps, on raw densities spread over the EOS's range, some at or
    below the floor, on occupied and empty slots."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.0, 1400.0, SHAPE).astype(np.float32)
    flat = raw.reshape(-1)
    flat[::11] = rng.choice([0.0, -3.0, 1e-9, 1e-6], flat[::11].shape)
    occ = (rng.random(SHAPE) < 0.6).astype(np.float32)
    jp, tp = params_pair(3, None)
    rho_j = jnp.where(occ > 0.5, jnp.maximum(raw, 1e-6), jp.rest_density)
    prs_j = jnp.where(occ > 0.5, jmodel.eos_pressure(rho_j, jp), 0.0)
    pr2_j = prs_j / (rho_j * rho_j)
    rho, prs, pr2 = tdense.density_tail(torch.from_numpy(raw),
                                        torch.from_numpy(occ), tp)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_j), rtol=1e-5)
    np.testing.assert_allclose(prs.numpy(), np.asarray(prs_j), rtol=1e-5,
                               atol=1e-6 * jp.tait_b)
    np.testing.assert_allclose(
        pr2.numpy(), np.asarray(pr2_j), rtol=1e-5,
        atol=1e-6 * jp.tait_b / jp.rest_density ** 2)
    assert (prs.numpy()[occ > 0.5] > 0).any()
    assert not prs.numpy()[occ < 0.5].any()
    assert (rho.numpy()[occ < 0.5] == tp.rest_density).all()


@pytest.mark.parametrize("ndim,obstacle,drag",
                         [(3, "box", True), (2, "cylinder_z", False)])
def test_wrappers_take_plain_route_on_cpu(ndim, obstacle, drag):
    """On CPU tensors the wrappers return the plain versions' tensors
    bitwise, launch nothing and build no library."""
    f = fields(seed=7, ndim=ndim)
    _, tp = params_pair(ndim, obstacle)
    _, td = states(f)
    _, tdrag = drags(drag)
    acc = [torch.from_numpy(f[a]) for a in ("ax", "ay", "az")]
    reset_launches()
    a = oi.integrate(td, *acc, tp, VMAX, drag=tdrag)
    b = tdense._integrate(td, *acc, tp, VMAX, drag=tdrag)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    raw, occ = torch.from_numpy(f["ax"]).abs(), td.occ
    for x, y in zip(oi.density_tail(raw, occ, tp),
                    tdense.density_tail(raw, occ, tp)):
        assert torch.equal(x, y)
    assert not any(LAUNCHES.values())
    assert build._LOADED is None


def test_step_goes_through_the_tail_wrappers_on_cpu():
    """dense_step with the kernel flag calls both wrappers (each takes its
    plain route here) and equals the step without it bitwise."""
    from sph_tpu_torch.sph.scenes import dam_break_3d_obstacle

    st, p = dam_break_3d_obstacle(n_target=2000, cell_factor=1.38,
                                  dense_k=8, rebin_every=6)
    spec = tdense.make_dense_spec(p, k=p.dense_k, cell_factor=p.cell_factor)
    d = tdense.pack(st, p, spec, device="cpu")
    drag = tmodel.FluidDrag.at((0.6, 0.3, 0.3), (0.7, 0.5, 0.3), 0.2,
                               device="cpu")
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(oi, "integrate", spy(oi.integrate))
        m.setattr(oi, "density_tail", spy(oi.density_tail))
        a = tdense.dense_step(d, p, spec, drag=drag, rebin_now=False)
    b = tdense.dense_step(d, dataclasses.replace(p, use_pallas=False), spec,
                          drag=drag, rebin_now=False)
    assert calls == ["density_tail", "integrate"]
    for f in ("px", "py", "pz", "vx", "vy", "vz", "rho", "prs", "clamped"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="at most 8"):
        oi.obstacle_table([OBSTACLES["sphere"]] * 9)
    with pytest.raises(ValueError, match="unknown obstacle"):
        oi.obstacle_table([("torus", (0, 0, 0), 1.0)])
    kinds, geometry = oi.obstacle_table([OBSTACLES["cylinder_z"],
                                         OBSTACLES["box"]])
    assert list(kinds) == [2, 1]
    assert list(geometry) == pytest.approx(
        [0.45, 0.35, 0.0, 0.15, 0.0, 0.0, 0.5, 0.3, 0.45, 0.2, 0.1, 0.15])
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        oi._operands("integrate", (x, x))
    # torch's pow specialises these exponents; the kernel computes powf.
    assert tmodel.SPHParams().gamma not in oi.SPECIAL_EXPONENTS


def test_importing_the_port_builds_nothing():
    code = """
import importlib, sys
for m in ("sph_tpu_torch.ops.integrate", "sph_tpu_torch.sph.dense",
          "sph_tpu_torch.parallel.dist", "sph_tpu_torch.utils.profiling",
          "sph_tpu_torch.utils.verify"):
    importlib.import_module(m)
from sph_tpu_torch.ops import build
assert build._LOADED is None
assert "sph_integrate" in build._ARGTYPES and "integrate.cu" in build.SOURCES
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=build.CSRC_DIR.parents[1])
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
