"""The port's package namespaces against the JAX package's: every name that
an `__init__.py` of `sph_tpu/` re-exports (or defines) is an attribute of
the port's matching package. The JAX files are parsed with `ast`, never
imported. `native/` (the C++ oracle) has no counterpart in the port.

Importing the port builds and loads no kernel library, and no subpackage
depends on being imported after another (no import cycle)."""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "sph_tpu"
SUBPACKAGES = sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py")
                     if p.parent.name != "native")


def exported(init: pathlib.Path) -> list[str]:
    """Names an `__init__.py` binds at its top level: imports and
    assignments."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def test_the_jax_namespaces_are_read():
    assert "engine" in SUBPACKAGES and "native" not in SUBPACKAGES
    assert exported(JAX_PKG / "__init__.py") == [
        "__version__", "Genome", "GenomeMode", "SimParams", "SimState",
        "Simulation"]
    assert exported(JAX_PKG / "engine" / "__init__.py") == ["step",
                                                            "Simulation"]


@pytest.mark.parametrize("sub", ["", *SUBPACKAGES])
def test_port_package_has_the_jax_names(sub):
    init = JAX_PKG / sub / "__init__.py"
    port = importlib.import_module(
        "sph_tpu_torch" + (f".{sub}" if sub else ""))
    missing = [n for n in exported(init) if not hasattr(port, n)]
    assert not missing, f"sph_tpu_torch.{sub or '__init__'} lacks {missing}"


def test_simulation_from_the_root():
    from sph_tpu_torch import Simulation
    from sph_tpu_torch.engine.simulation import Simulation as Sim

    assert Simulation is Sim


def test_imports_load_no_library_and_have_no_cycle():
    """Each subpackage imported first in a clean package state (every
    sph_tpu_torch module dropped from sys.modules before each), and the
    kernel library never built or loaded."""
    subs = ["", *SUBPACKAGES, "bench", "parallel.dryrun"]
    code = f"""
import importlib, sys
for sub in {subs!r}:
    for m in [m for m in sys.modules if m.split(".")[0] == "sph_tpu_torch"]:
        del sys.modules[m]
    importlib.import_module("sph_tpu_torch" + ("." + sub if sub else ""))
    build = sys.modules.get("sph_tpu_torch.ops.build")
    assert build is None or build._LOADED is None, sub
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
