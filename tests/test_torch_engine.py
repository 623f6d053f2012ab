"""Port vs reference for the whole slice: FluidSimulation runs, carrying a
JAX checkpoint across, the port's own checkpoints, pick/drag, and the rule
that the port imports no JAX (nor PIL).

The 60-step runs compare statistics, never slot-for-slot arrays: XLA may
contract FMAs where torch on the CPU does not, and a particle within an ulp
of a cell edge can then rebin into the neighbouring cell. The JAX side runs
its XLA twin (use_pallas=False); Pallas interpret mode is too slow for 60
steps."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu.engine.fluid import FluidSimulation as JaxFluidSimulation
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.sph.dense import DenseFluidState
from sph_tpu_torch.utils.convert import params_from_jax, state_from_numpy

torch.set_num_threads(1)

# The cylinder's h/2 boundary layer reaches the column's right edge, so
# the obstacle pushes a few particles without driving any to the vmax
# clamp (a clamp count would then hang on last-ulp speeds).
CYL = (("cylinder_z", (0.6, 0.2), 0.1),)
SCENE_2D = dict(n_target=300, obstacles=CYL, dense_k=4, cell_factor=1.2,
                rebin_every=3, use_pallas=False)


def stats(pos, rho):
    return pos.mean(0), pos.std(0), float(rho.mean())


def assert_same_flow(jax_sim, sim):
    """Counts exact; centroid and spread atol 5e-3 (tests/test_dense.py);
    mean density rtol 1e-3."""
    mj, mt = jax_sim.metrics(), sim.metrics()
    for key in ("step", "n_particles", "dropped", "clamped"):
        assert mt[key] == mj[key], key
    pj, _, rj, _ = jax_sim.particles()
    pt, _, rt, _ = sim.particles()
    (cj, sj, dj), (ct, st, dt) = stats(pj, rj), stats(pt, rt)
    np.testing.assert_allclose(ct, cj, atol=5e-3)
    np.testing.assert_allclose(st, sj, atol=5e-3)
    np.testing.assert_allclose(dt, dj, rtol=1e-3)


def test_slice_matches_jax_60_steps():
    sim = FluidSimulation.from_scene("dam_break_2d", substeps=20,
                                     device="cpu", **SCENE_2D)
    jsim = JaxFluidSimulation.from_scene("dam_break_2d", substeps=20,
                                         **SCENE_2D)
    # The obstacle pushes at the start: some particle sits in its layer.
    from sph_tpu_torch.sph.model import obstacle_accel

    pos0 = sim.particles()[0]
    assert np.abs(obstacle_accel(torch.from_numpy(pos0),
                                 sim.params).numpy()).max() > 0
    sim.run(60)
    jsim.run(60)
    assert sim.metrics()["step"] == 60
    assert sim.dstate.step_count.dtype == torch.int32
    assert sim.metrics()["dropped"] == 0
    assert_same_flow(jsim, sim)


def test_jax_checkpoint_carries_across(tmp_path):
    jsim = JaxFluidSimulation.from_scene("dam_break_2d", substeps=5,
                                         **SCENE_2D)
    jsim.run(10)
    path = str(tmp_path / "jax.npz")
    jsim.save(path)

    sim = FluidSimulation.load(path, device="cpu")
    assert dataclasses.asdict(sim.params) == dataclasses.asdict(jsim.params)
    assert sim.params.obstacles == CYL            # nested tuples restored
    assert sim.substeps == 5
    for f in dataclasses.fields(DenseFluidState):
        np.testing.assert_array_equal(
            getattr(sim.dstate, f.name).numpy(),
            np.asarray(getattr(jsim.dstate, f.name)), err_msg=f.name)
    sim.run(20)
    jsim.run(20)
    assert_same_flow(jsim, sim)


def test_convert_helpers():
    jsim = JaxFluidSimulation.from_scene("dam_break_2d", substeps=5,
                                         **SCENE_2D)
    p = params_from_jax(dataclasses.asdict(jsim.params))
    assert dataclasses.asdict(p) == dataclasses.asdict(jsim.params)
    with pytest.raises(ValueError, match="unknown"):
        params_from_jax({**dataclasses.asdict(jsim.params), "mesh": 1})
    arrays = {f.name: np.asarray(getattr(jsim.dstate, f.name))
              for f in dataclasses.fields(DenseFluidState)}
    d = state_from_numpy(arrays, device="cpu")
    assert d.px.dtype == torch.float32 and d.dropped.dtype == torch.int32
    assert d.step_count.shape == ()
    np.testing.assert_array_equal(d.occ.numpy(), arrays["occ"])


def test_checkpoint_roundtrip_bitwise(tmp_path):
    sim = FluidSimulation.from_scene("dam_break_2d", substeps=6,
                                     device="cpu", **SCENE_2D)
    sim.run(12)
    path = str(tmp_path / "port.npz")
    sim.save(path)
    sim2 = FluidSimulation.load(path, device="cpu")
    for f in dataclasses.fields(DenseFluidState):
        assert torch.equal(getattr(sim.dstate, f.name),
                           getattr(sim2.dstate, f.name)), f.name
    sim.run(12)
    sim2.run(12)
    for f in dataclasses.fields(DenseFluidState):
        assert torch.equal(getattr(sim.dstate, f.name),
                           getattr(sim2.dstate, f.name)), f.name
    assert sim2.metrics()["step"] == 24


def test_pick_drag_and_metrics(tmp_path):
    sim = FluidSimulation.from_scene("dam_break_3d", n_target=400,
                                     substeps=5, device="cpu")
    sim.run(5)
    pos0 = sim.particles()[0]
    anchor = pos0[len(pos0) // 2]
    hit = sim.pick(anchor + np.array([0, 0, -1], np.float32), (0, 0, 1))
    assert hit is not None and np.linalg.norm(hit - anchor) < 4 * sim.params.h
    assert sim.pick((10.0, 10.0, 10.0), (1, 0, 0)) is None

    path = str(tmp_path / "before_drag.npz")
    sim.save(path)
    baseline = FluidSimulation.load(path, device="cpu")
    target = anchor + np.array([0.0, 0.3, 0.0], np.float32)
    sim.set_drag(anchor, target, strength=5000.0)
    sim.run(30)
    baseline.run(30)
    assert sim.particles()[0][:, 1].mean() > (
        baseline.particles()[0][:, 1].mean() + 1e-4)
    sim.clear_drag()
    sim.run(5)
    m = sim.metrics()
    assert m["step"] == 40 and m["dropped"] == 0
    assert m["n_particles"] == len(pos0)
    assert np.isfinite(m["kinetic_energy"]) and m["mean_density"] > 100.0
    assert m["steps_per_sec"] > 0


PKG = pathlib.Path(__file__).resolve().parents[1] / "sph_tpu_torch"


def test_port_imports_no_jax():
    for path in [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "sph_tpu", "PIL"), (
                    f"{path.relative_to(PKG.parent)} imports {name}")
    modules = sorted(
        ".".join(path.relative_to(PKG.parent).with_suffix("").parts)
        for path in PKG.rglob("*.py") if path.name != "__init__.py")
    for name in ("engine.simulation", "engine.checkpoint", "engine.recovery",
                 "engine.config", "ops.grid", "sph.model", "render.camera",
                 "render.splat", "render.impostor", "render.overlay",
                 "render.raster", "render.image", "app.viewer",
                 "app.__main__", "utils.profiling", "bench",
                 "parallel.dryrun"):
        assert f"sph_tpu_torch.{name}" in modules, name
    code = (f"import sys; import {', '.join(modules)};"
            " assert 'jax' not in sys.modules, 'jax imported';"
            " assert 'PIL' not in sys.modules, 'PIL imported';"
            " assert not any(m == 'sph_tpu' or m.startswith('sph_tpu.')"
            " for m in sys.modules), 'sph_tpu imported'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PKG.parent, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
