"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips on a host without a
CUDA device; this file imports no JAX, so on the card it runs without the
repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 are held to rtol 1e-5, atol 1e-6·max|x| on occupied
slots (sph_tpu_torch.utils.verify) and, by their design (the plain
version's summation order, no FMA contraction), to bitwise equality; K3 is
bitwise. K4 (colony contact sweep) is held to the same tolerance on every
slot and, by the same design, to bitwise equality; K5 (the contact pack's
placement) is bitwise."""

import pytest
import torch

from sph_tpu_torch.core.types import state_to_numpy
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.engine.fluid import FluidSimulation
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.ops import LAUNCHES, reset_launches
from sph_tpu_torch.ops.contact import contact_sweep
from sph_tpu_torch.ops.expand import expand_rows
from sph_tpu_torch.ops.fluid import accel_sweep, density_sweep
from sph_tpu_torch.physics import contact_dense as cd
from sph_tpu_torch.sph import dense
from sph_tpu_torch.utils.verify import (
    accel_inputs,
    check_contact,
    check_expand,
    check_fluid_twins,
    compressed,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SCENES = {
    "3d": ("dam_break_3d_obstacle", dict(n_target=20000, cell_factor=1.38,
                                         dense_k=8, rebin_every=6)),
    "2d": ("dam_break_2d", dict(n_target=4096, dense_k=4, cell_factor=1.2,
                                rebin_every=3)),
}
COLONY = dict(neighbor_mode="dense", max_splits_per_step=64, dense_k=2,
              use_pallas=True)


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
    assert LAUNCHES == {"density": 12, "accel": 12, "rebin_stage": 6,
                        "contact": 0, "expand": 0}
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


def colony(cuda, n=20000):
    state, params, genome = bonded_colony(n, device=cuda, **COLONY)
    spec = cd.make_contact_spec(params, k=params.dense_k,
                                cell_factor=params.dense_cell_factor)
    return state, params, genome, spec


def test_contact_and_expand_kernels_match_plain(cuda):
    state, params, _, spec = colony(cuda)
    settled = check_contact(state, params, spec)
    squeezed = check_contact(compressed(state, 0.7), params, spec)
    assert squeezed["contact_slots"] > 0
    assert settled["bitwise"] and squeezed["bitwise"]
    assert check_expand(state, spec)["rows"] == 20000


def test_contact_kernel_keeps_nan_overlap(cuda):
    """A NaN radius makes NaN overlaps, which the kernel does not skip: on
    occupied slots it equals the plain sweep, NaN for NaN."""
    state, params, _, spec = colony(cuda, n=2000)
    squeezed = compressed(state, 0.7)
    radius = squeezed.radius.clone()
    radius[7] = float("nan")
    fields, occ, _, _ = cd._pack_args(squeezed.replace_fields(radius=radius),
                                      spec)
    plain = cd._sweep_plain(
        fields, lambda *a: cd.contact_pair_terms(params, *a), 6, spec)
    kern = contact_sweep(fields, occ, params, spec)
    m = occ > 0.5
    assert bool(plain[0][m].isnan().any())
    for a, b in zip(kern, plain):
        assert torch.equal(a[m].view(torch.int32).masked_fill(a[m].isnan(), 0),
                           b[m].view(torch.int32).masked_fill(b[m].isnan(), 0))
        assert torch.equal(a[m].isnan(), b[m].isnan())


def test_colony_main_path_launches_kernels(cuda):
    state, params, genome, _ = colony(cuda)
    n_bonds = int(state.bonds.active.sum())
    sim = Simulation(genome, params, device=cuda)
    sim.state = state
    reset_launches()
    sim.step(10)
    torch.cuda.synchronize()
    assert LAUNCHES["contact"] == 10 and LAUNCHES["expand"] == 10
    m = sim.metrics()
    assert m["active_particles"] == 20000 and m["overflow"] == 0
    assert m["bond_count"] <= n_bonds
    assert bool(torch.isfinite(sim.state.pos).all())


def test_colony_kernel_path_equals_plain_path(cuda):
    """With bitwise K4 and K5 the colony trajectory is bitwise too."""
    state, params, genome, _ = colony(cuda, n=4000)
    sims = [Simulation(genome, params.replace(use_pallas=flag), device=cuda)
            for flag in (True, False)]
    for s in sims:
        s.state = state
        s.step(10)
    a, b = (state_to_numpy(s.state) for s in sims)
    for k in a:
        assert (a[k] == b[k]).all(), k


def test_colony_wrappers_refuse_bad_operands(cuda):
    state, params, _, spec = colony(cuda, n=2000)
    fields, occ, _, _ = cd._pack_args(state, spec, expand=True)
    with pytest.raises(TypeError, match="float32"):
        contact_sweep([fields[0].double(), *fields[1:]], occ, params, spec)
    with pytest.raises(ValueError, match="shape"):
        contact_sweep([f[:, :8] for f in fields], occ, params, spec)
    rows, flat, fits, _, _ = cd._sort_with_payload(state, spec)
    with pytest.raises(ValueError, match="int32"):
        expand_rows(rows, flat.long(), fits, cd.PACK_FILLS, spec)
    with pytest.raises(ValueError, match="fills"):
        expand_rows(rows, flat, fits, cd.PACK_FILLS[:5], spec)
