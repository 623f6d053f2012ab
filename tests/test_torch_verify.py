"""The port's hardware verification lane (sph_tpu_torch/utils/verify.py:
CHECKS, run_all, verify_summary and its CLI) on the CPU, where every
kernel wrapper runs its plain version, and the last names the port
carries over from the JAX package: engine.step.make_step_fn,
core.quat.IDENTITY and biology.ZONE_A/B/C."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import sph_tpu.biology as jbio
import sph_tpu.utils.verify as jverify
from sph_tpu.core import quat as jquat
from sph_tpu_torch import biology as tbio
from sph_tpu_torch.core import quat as tquat
from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.ops import contact as oc
from sph_tpu_torch.utils import verify

# The package re-exports the function `step` (as sph_tpu.engine does), which
# shadows the submodule of that name: take the module from the import system.
tstep = importlib.import_module("sph_tpu_torch.engine.step")

torch.set_num_threads(1)

def test_run_all_on_the_cpu_has_jax_checks_and_passes():
    results = verify.run_all(device="cpu")
    names = [n for n, _ in jverify.CHECKS]
    assert [n for n, _ in results] == names and len(names) == 7
    assert [e for _, e in results] == [None] * 7
    assert verify.verify_summary(device="cpu") == "ok (cpu, 7 twin checks)"


@pytest.fixture
def perturbed_sweep(monkeypatch):
    """The contact sweep's wrapper with its force scaled by 1 + 1e-3, as a
    wrong kernel would give it."""
    sweep = oc.contact_sweep

    def wrong(*a, **kw):
        outs = sweep(*a, **kw)
        return [o * 1.001 for o in outs[:3]] + outs[3:]

    monkeypatch.setattr(oc, "contact_sweep", wrong)


def test_a_perturbed_check_fails_in_the_summary(perturbed_sweep):
    summary = verify.verify_summary(device="cpu")
    assert summary.startswith("FAIL: contact end-to-end n=400 k=4: ")
    assert "contact force" in summary


def test_cli_exit_codes(perturbed_sweep, monkeypatch, capsys):
    assert verify.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "6/7 twin checks ok" in out
    assert "FAIL contact end-to-end n=400 k=4" in out
    monkeypatch.undo()
    assert verify.main(["--device", "cpu"]) == 0
    assert "7/7 twin checks ok" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert verify.main([]) == 1


def test_make_step_fn_is_memoised_and_equals_step():
    state, params, genome = bonded_colony(64, device="cpu", dense_k=2,
                                          max_splits_per_step=4)
    gd = genome.to_device("cpu")
    fn = tstep.make_step_fn(params)
    assert tstep.make_step_fn(dataclasses.replace(params)) is fn
    assert tstep.make_step_fn(params, donate=False) is fn
    contact = lambda st: tstep.contact_forces(st, params)  # noqa: E731
    with_hook = tstep.make_step_fn(params, contact_fn=contact)
    assert tstep.make_step_fn(params, contact_fn=contact) is not with_hook
    want = tstep.step(state, params, gd)
    for got in (fn(state, gd), with_hook(state, gd)):
        for f in ("pos", "vel", "rot", "ang_vel", "step_count"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_identity_and_zones_equal_jax():
    np.testing.assert_array_equal(tquat.IDENTITY.numpy(),
                                  np.asarray(jquat.IDENTITY))
    assert tquat.IDENTITY.dtype == torch.float32
    assert torch.equal(tquat.identity((3,), device="cpu"),
                       tquat.IDENTITY.expand(3, 4))
    assert (tbio.ZONE_A, tbio.ZONE_B, tbio.ZONE_C) == (
        jbio.ZONE_A, jbio.ZONE_B, jbio.ZONE_C)
