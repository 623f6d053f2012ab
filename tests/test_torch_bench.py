"""Port vs reference for the benchmark harness (sph_tpu_torch.bench against
the repository's bench.py) and the sharded dryrun (parallel/dryrun.py).

Each rung function runs at a tiny size in both packages on the CPU: JAX
through its Pallas interpret mode, the port through the kernels' plain
versions. Timings differ by nature; the key sets (apart from the port's
`launches`) and the integer fields are held equal. `main` runs with
CONFIGS, CELLS and BREAKDOWN cut to tiny rungs and `--device cpu`."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from sph_tpu_torch import bench
from sph_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The integer fields of a rung's entry that both packages must agree on.
INTS = ("n_particles", "alive", "dropped", "bonds", "cell_overflow")
CONTRACT = {"metric", "value", "unit", "vs_baseline", "detail", "device"}


@pytest.fixture(scope="module")
def jbench():
    """The repository's bench.py (JAX), loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rates", [[7.25], [1.0, 3.5, 2.0],
                                   [0.5, 0.25, 4.0, 4.0001]])
def test_rate_stats_equals_jax(jbench, rates):
    for n in (1, 2080, 1_005_312):
        assert bench._rate_stats(rates, n) == jbench._rate_stats(rates, n)


RUNGS = {
    "dense_3d": ("_bench_dense", dict(n_target=2000, steps=4, substeps=2)),
    "dense_2d": ("_bench_2d_dense", dict(n_target=400, steps=4,
                                         substeps=2)),
    "bruteforce_2d": ("_bench_2d_bruteforce", dict(n_target=300, steps=4)),
    "cells_dense": ("_bench_cells", dict(n=512, steps=4, chunk=2)),
    "cells_grid": ("_bench_cells", dict(n=512, steps=4, chunk=2,
                                        neighbor_mode="grid")),
}


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_rung_matches_jax(jbench, name):
    fn, kw = RUNGS[name]
    want = getattr(jbench, fn)(**kw)
    got = getattr(bench, fn)(device="cpu", **kw)
    assert set(got) - {"launches"} == set(want)
    for key in INTS:
        if key in want:
            assert got[key] == want[key], key
    assert got.get("neighbor_mode") == want.get("neighbor_mode")
    assert got.get("backend") == want.get("backend")
    # On the CPU the wrappers run their plain versions: nothing launched.
    assert set(got["launches"]) == {"density", "accel", "rebin", "contact",
                                    "expand"}
    assert not any(got["launches"].values())
    assert got["steps_per_sec"] > 0


def tiny_configs(fail: int | None = None):
    """bench.CONFIGS under its own names, each rung cut to a tiny one;
    rung `fail` raises."""
    def boom(device):
        raise RuntimeError("rung fails on purpose")

    fns = {
        0: lambda device: bench._bench_2d_bruteforce(200, steps=2,
                                                     device=device),
        1: lambda device: bench._bench_2d_dense(300, steps=2, substeps=1,
                                                device=device),
        2: lambda device: bench._bench_dense(600, steps=2, substeps=1,
                                             device=device),
        3: lambda device: bench._bench_dense(
            600, steps=2, substeps=1, obstacles=bench.OBSTACLE,
            cell_factor=1.38, device=device),
        4: lambda device: bench._bench_dense(600, steps=2, substeps=1,
                                             cell_factor=1.35,
                                             device=device),
    }
    return {i: (name, boom if i == fail else fns[i])
            for i, (name, _) in bench.CONFIGS.items()}


def run_main(capsys, argv) -> tuple[int, dict]:
    rc = bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_main_all_prints_one_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "CONFIGS", tiny_configs(fail=4))
    rc, out = run_main(capsys, ["--all", "--device", "cpu", "--no-verify"])
    assert rc == 0
    assert set(out) == CONTRACT
    names = [name for name, _ in bench.CONFIGS.values()]
    assert list(out["detail"]) == names
    head = out["detail"][names[3]]
    assert out["metric"] == f"particle-steps/sec ({names[3]}, 1 chip)"
    assert out["unit"] == "particle-steps/sec"
    assert out["value"] == head["particle_steps_per_sec"] > 0
    assert out["vs_baseline"] == round(out["value"] / 60e6, 4)
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert out["detail"][names[4]] == {"error": "rung fails on purpose"}
    for name in names[:4]:
        entry = out["detail"][name]
        assert "error" not in entry and entry["n_particles"] > 0
        assert not any(entry["launches"].values())


def test_main_cells_breakdown_and_verify(monkeypatch, capsys):
    monkeypatch.setattr(bench, "CONFIGS", tiny_configs())
    monkeypatch.setattr(bench, "CELLS", ((512, "grid", 2, 1),
                                         (512, "dense", 2, 1)))
    monkeypatch.setattr(bench, "BREAKDOWN", {
        "phase_breakdown_256k": dict(n_target=300, obstacles=(),
                                     cell_factor=1.25)})
    calls = []

    def lane(device="cuda"):
        calls.append(torch.device(device).type)
        return "ok (cpu, 7 twin checks)"

    monkeypatch.setattr("sph_tpu_torch.utils.verify.verify_summary", lane)
    # step_breakdown's own windows (4 × 30 applications a phase) take half
    # a minute of plain sweeps here: one of 2 (its tests are
    # tests/test_torch_app.py's).
    from sph_tpu_torch.utils import profiling

    splits = []

    def breakdown(d, params, spec):
        splits.append((params.dense_k, params.cell_factor,
                       params.rebin_every, params.use_pallas, spec.k,
                       d.px.device.type))
        return real_breakdown(d, params, spec, n=1, sub=2)

    real_breakdown = profiling.step_breakdown
    monkeypatch.setattr(profiling, "step_breakdown", breakdown)
    rc, out = run_main(capsys, ["--config", "0", "--cells", "--breakdown",
                                "--device", "cpu"])
    assert rc == 0
    assert set(out) == CONTRACT | {"verify"}
    assert out["verify"] == "ok (cpu, 7 twin checks)" and calls == ["cpu"]
    name0 = bench.CONFIGS[0][0]
    assert list(out["detail"]) == [
        name0, "cell colony 0k (contact+adhesion, grid)",
        "cell colony 0k (contact+adhesion, dense)", "phase_breakdown_256k"]
    assert out["value"] == out["detail"][name0]["particle_steps_per_sec"]
    for key in list(out["detail"])[1:3]:
        assert out["detail"][key]["bonds"] == 750
        assert out["detail"][key]["cell_overflow"] == 0
    split = out["detail"]["phase_breakdown_256k"]
    assert split["full_step_ms"] > 0 and "density_gbps" in split
    assert splits == [(8, 1.25, 6, True, 8, "cpu")]

    # A colony rung that raises becomes {"error": ...}; the line prints.
    def boom(*a, **kw):
        raise ValueError("colony fails on purpose")

    monkeypatch.setattr(bench, "_bench_cells", boom)
    rc, out = run_main(capsys, ["--config", "0", "--cells", "--no-verify",
                                "--device", "cpu"])
    assert rc == 0 and "verify" not in out
    assert out["detail"]["cell colony 0k (contact+adhesion, dense)"] == {
        "error": "colony fails on purpose"}


def test_main_without_a_card_fails_with_an_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = run_main(capsys, ["--all", "--cells"])
    assert rc != 0
    assert out["value"] == 0.0 and "no CUDA device" in out["error"]
    assert {"metric", "value", "unit", "vs_baseline"} <= set(out)


def test_cli_without_a_card_exits_nonzero():
    r = subprocess.run([sys.executable, "-m", "sph_tpu_torch.bench"],
                       capture_output=True, text=True, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       timeout=120)
    assert r.returncode != 0
    lines = r.stdout.splitlines()
    assert len(lines) == 1 and "error" in json.loads(lines[0]), r.stdout


def test_dryrun_within_no_budget(capfd):
    dryrun.dryrun_multichip(4, device="cpu", budget_s=0)
    err = capfd.readouterr().err
    for check in ("fluid 1D", "fluid 2D", "contact 1D", "contact 2D",
                  "colony"):
        assert f"{check}: PASS" in err, check
    assert "division: SKIPPED" in err and "large-scale: SKIPPED" in err
    assert "ALL CHECKS PASSED" in err


def test_dryrun_full_runs_division_and_large_scale(monkeypatch, capfd):
    monkeypatch.setattr(dryrun, "LARGE_N", (3000, 3000))
    dryrun.dryrun_multichip(2, device="cpu", budget_s=0, full=True)
    err = capfd.readouterr().err
    assert "division: PASS" in err
    assert "large-scale: building n=3000" in err
    assert "large-scale: PASS" in err and "ALL CHECKS PASSED" in err


def test_bitwise_check_sees_one_ulp():
    a = torch.linspace(0.0, 1.0, 64)
    b = a.clone()
    b[7] = torch.nextafter(b[7], torch.tensor(2.0))
    dryrun._bitwise("same", {"x": a}, {"x": a.clone()})
    with pytest.raises(AssertionError, match="x differs .* in 1 elements"):
        dryrun._bitwise("one ulp", {"x": a}, {"x": b})
    z = torch.zeros(3)
    with pytest.raises(AssertionError):
        dryrun._bitwise("signed zero", {"x": z}, {"x": -z})
