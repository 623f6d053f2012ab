"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips on a host without a
CUDA device; this file imports no JAX, so on the card it runs without the
repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 are held to rtol 1e-5, atol 1e-6·max|x| on occupied
slots (sph_tpu_torch.utils.verify) and, by their design (the plain
version's summation order, no FMA contraction), to bitwise equality; K3 is
bitwise."""

import pytest
import torch

from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.ops import LAUNCHES, reset_launches
from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
from sph_tpu_torch.sph import dense
from sph_tpu_torch.utils.verify import accel_inputs, check_fluid_twins

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SCENES = {
    "3d": ("dam_break_3d_obstacle", dict(n_target=20000, cell_factor=1.38,
                                         dense_k=8, rebin_every=6)),
    "2d": ("dam_break_2d", dict(n_target=4096, dense_k=4, cell_factor=1.2,
                                rebin_every=3)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", sorted(SCENES))
def test_kernels_match_plain(cuda, case):
    scene, kw = SCENES[case]
    sim = FluidSimulation.from_scene(scene, substeps=6, device=cuda, **kw)
    sim.run(12)
    d, p, spec = sim.dstate, sim.params, sim.spec
    r = check_fluid_twins(d, p, spec, seed=3)
    assert r["rebin_stage"]["dropped"] > 0
    m = d.occ > 0.5
    assert torch.equal(density_sweep(d.px, d.py, d.pz, d.occ, p, spec)[m],
                       dense.density_raw(d.px, d.py, d.pz, p, spec)[m])
    d2 = accel_inputs(d, p, spec)
    pr2 = d2.prs / (d2.rho * d2.rho)
    plain = dense.accel_raw(d2, torch.reciprocal(d2.rho), pr2, p, spec)
    for a, b in zip(accel_sweep(d2, pr2, p, spec), plain):
        assert torch.equal(a[m], b[m])


def test_main_path_launches_kernels(cuda):
    scene, kw = SCENES["3d"]
    sim = FluidSimulation.from_scene(scene, substeps=6, device=cuda, **kw)
    n0 = sim.metrics()["n_particles"]
    reset_launches()
    sim.run(12)
    torch.cuda.synchronize()
    assert LAUNCHES == {"density": 12, "accel": 12, "rebin_stage": 6}
    m = sim.metrics()
    assert m["n_particles"] == n0 and m["dropped"] == 0


def test_kernel_path_equals_plain_path(cuda):
    """With bitwise kernels the whole trajectory is bitwise too."""
    scene, kw = SCENES["2d"]
    sims = [FluidSimulation.from_scene(scene, substeps=6, device=cuda,
                                       use_pallas=flag, **kw)
            for flag in (True, False)]
    for s in sims:
        s.run(30)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "occ", "rho", "prs",
              "dropped", "clamped"):
        assert torch.equal(getattr(sims[0].dstate, f),
                           getattr(sims[1].dstate, f)), f


def test_wrappers_refuse_bad_operands(cuda):
    scene, kw = SCENES["2d"]
    sim = FluidSimulation.from_scene(scene, device=cuda, **kw)
    d, p, spec = sim.dstate, sim.params, sim.spec
    with pytest.raises(TypeError, match="float32"):
        density_sweep(d.px.double(), d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="contiguous"):
        t = d.px.transpose(1, 2).contiguous().transpose(1, 2)
        density_sweep(t, d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="shape"):
        density_sweep(d.px[:, :2], d.py, d.pz, d.occ, p, spec)
    with pytest.raises(ValueError, match="CUDA"):
        density_sweep(d.px, d.py.cpu(), d.pz, d.occ, p, spec)
