"""Where the port's dense fluid step and JAX's part, and who sides with
whom: tests/test_torch_dist.py's random-fluid cases, each stepped on one
device by the port (float32, and float64 as a witness of the exact
dynamics), by JAX jitted (XLA fuses the step and contracts a·b + c into
FMAs) and by JAX op by op (jax.disable_jit: no fusion). Prints, after
AGREE_STEPS steps and after the case's whole run, for every float field
and pair of runs, the slots beyond the twin tolerance (rtol 1e-5 plus
atol 1e-6·max|x| over occupied slots, of the second run) and the largest
|Δ| in units of that tolerance. The port's sharded runs are bitwise its
single-device runs (tests/test_torch_dist.py), so this holds for them.

    JAX_PLATFORMS=cpu python tools/compare_dist_twins.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import test_torch_dist as cases  # noqa: E402
from sph_tpu_torch.sph import dense as tdense  # noqa: E402

FLOATS = ("px", "py", "pz", "vx", "vy", "vz", "rho", "prs")


def port64(c, steps):
    d = dataclasses.replace(c.td0, **{f: getattr(c.td0, f).double()
                                      for f in cases.FIELDS})
    out = tdense.make_dense_step(c.tp, c.tspec, steps)(d, 0)
    return {f: getattr(out, f).numpy() for f in cases.FIELDS}


def main() -> None:
    pairs = (("port", "jit"), ("eager", "jit"), ("port", "eager"),
             ("port", "f64"), ("jit", "f64"), ("eager", "f64"))
    for name, (_, _, sub) in cases.FLUID.items():
        c = cases.fluid_case(name)
        for steps in (cases.AGREE_STEPS, sub):
            runs = {"port": c.single(steps), "jit": c.jax_single(steps),
                    "eager": c.jax_eager(steps), "f64": port64(c, steps)}
            occ = runs["port"]["occ"]
            same = all(np.array_equal(r["occ"], occ) for r in runs.values())
            print(f"{name}, {steps} steps: occupancy equal in all four runs:"
                  f" {same}")
            for f in FLOATS:
                parts = []
                for a, b in pairs:
                    x, y = runs[a][f], runs[b][f]
                    scale = float(np.abs(y[occ > 0.5]).max())
                    tol = 1e-5 * np.abs(y) + 1e-6 * scale
                    r = np.abs(x - y) / tol
                    parts.append(f"{a}~{b} {int((r > 1).sum())} "
                                 f"{float(r.max()):.3g}")
                print(f"  {f}: " + " | ".join(parts))


if __name__ == "__main__":
    main()
