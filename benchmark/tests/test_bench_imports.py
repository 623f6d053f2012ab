"""The import guard (whole top-level names: sph_tpu_torch is not
sph_tpu), a reference that imports nothing of the program, and a harness
that exits with no result where it has no card or no program."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import device, spec


@pytest.mark.parametrize("modules, found", [
    (["sph_tpu_torch", "sph_tpu_torch.engine.simulation", "torch"], []),
    (["sph_tpu.sph.dense", "numpy"], ["sph_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax"], ["flax"]),
    (["jaxtyping", "sph_tpu_tools"], []),
])
def test_forbidden_modules_compares_whole_names(modules, found):
    assert device.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"sph_tpu_torch", "sph_tpu", "jax", "jaxlib"}, path
        assert tops <= {"__future__", "math", "itertools", "numpy", "torch",
                        "benchmark"}, (path, tops)
    code = ("import sys; import benchmark.reference.colony, "
            "benchmark.reference.grid; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sph_tpu_torch', 'sph_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax():
    code = ("import sys\n"
            "sys.argv = ['x']\n"
            "from benchmark.tests.conftest import run_tiny\n"
            "res = run_tiny('colony_1m')\n"
            "from benchmark.harness.device import forbidden_modules\n"
            "print(res['correct'], forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.stdout.strip().splitlines()[-1] == "True []", out.stderr


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "colony_1m", "--seed", "5000000001", "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
