"""The planned adhesion accumulate against the plain one in both packages,
on the CPU: the scene of utils/verify.check_planned_adhesion (the
n-cell bonded colony, dense, k = 2, kernels on: Pallas in interpret mode
in JAX, the plain versions in the port), stepped one step at a time with
adhesion_plan "off" and "on". Prints, after each step and for each
package, the largest |Δ| of velocities and quaternions between the two
runs and its worst ratio to the lane's tolerance (rtol 1e-4 with atol
1e-5, the JAX check's, and for the quaternions also atol 1e-4, the
port's).

    JAX_PLATFORMS=cpu python tools/compare_planned_adhesion.py [n] [steps]
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from sph_tpu.engine.colony import bonded_colony as jax_colony  # noqa: E402
from sph_tpu.engine.step import run_steps as jax_run_steps  # noqa: E402
from sph_tpu_torch.engine.colony import bonded_colony  # noqa: E402
from sph_tpu_torch.engine.step import run_steps  # noqa: E402


def worst(x, y, atol: float) -> tuple[float, float]:
    d = np.abs(x - y)
    return float(d.max()), float((d / (atol + 1e-4 * np.abs(x))).max())


def report(pkg: str, k: int, a: dict, b: dict) -> None:
    out = [f"{pkg} step {k}:"]
    for f, atols in (("vel", (1e-5,)), ("rot", (1e-5, 1e-4))):
        for atol in atols:
            m, r = worst(a[f], b[f], atol)
            out.append(f"{f} max|d| {m:.3g} ratio(atol {atol:g}) {r:.3g}")
    print("  ".join(out), flush=True)


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    torch.set_num_threads(4)
    kw = dict(neighbor_mode="dense", dense_k=2, use_pallas=True)

    jst, jp, jg = jax_colony(n, **kw)
    jgd = jg.to_device()
    one = {m: jax.jit(lambda s, p=dataclasses.replace(jp, adhesion_plan=m):
                      jax_run_steps(s, p, jgd, 1)) for m in ("off", "on")}
    tst, tp, tg = bonded_colony(n, device="cpu", **kw)
    tgd = tg.to_device("cpu")
    ja = jb = jst
    ta = tb = tst
    for k in range(1, steps + 1):
        ja, jb = one["off"](ja), one["on"](jb)
        nb = int(ja.active_count)
        report("jax  ", k, {f: np.asarray(getattr(ja, f))[:nb]
                            for f in ("vel", "rot")},
               {f: np.asarray(getattr(jb, f))[:nb] for f in ("vel", "rot")})
        ta = run_steps(ta, tp.replace(adhesion_plan="off"), tgd, 1)
        tb = run_steps(tb, tp.replace(adhesion_plan="on"), tgd, 1)
        report("port ", k, {f: getattr(ta, f)[:nb].numpy()
                            for f in ("vel", "rot")},
               {f: getattr(tb, f)[:nb].numpy() for f in ("vel", "rot")})


if __name__ == "__main__":
    main()
