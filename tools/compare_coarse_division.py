"""Both packages' colony through a division at a coarse step, on the CPU:
the reference scene (capacity 16, dt 0.5) grown 24 steps in the JAX
package and carried across to the port, then 9 × 2 more steps in each,
free and with cell 1 dragged (strength 100). Prints, after each pair of
steps, both active counts and the largest |Δ position| between them.

    JAX_PLATFORMS=cpu python tools/compare_coarse_division.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sph_tpu import Simulation as JaxSimulation  # noqa: E402
from sph_tpu.core import types as jtypes  # noqa: E402
from sph_tpu.engine import config as jconfig  # noqa: E402
from sph_tpu_torch.engine.simulation import Simulation  # noqa: E402
from sph_tpu_torch.utils.convert import colony_from_jax  # noqa: E402


def main() -> None:
    p = jconfig.reference_scene_params(capacity=16).replace(
        dt=0.5, max_splits_per_step=8, max_bonds=64)
    g = jconfig.reference_genome()
    for drag in (False, True):
        jsim = JaxSimulation(g, p, scan_chunk=2)
        jsim.step(24)
        st, tp, tg = colony_from_jax(jtypes.state_to_numpy(jsim.state),
                                     dataclasses.asdict(p),
                                     jconfig.genome_to_json(g), device="cpu")
        sim = Simulation(tg, tp, device="cpu")
        sim.state = st
        if drag:
            for s in (jsim, sim):
                s.set_drag(1, (5.0, 5.0, 0.0), 100.0)
        rows = []
        for _ in range(9):
            jsim.step(2)
            sim.step(2)
            err = np.abs(sim.state.pos.numpy()
                         - np.asarray(jsim.state.pos)).max()
            rows.append((int(sim.state.step_count),
                         int(sim.state.active_count),
                         int(jsim.state.active_count), float(err)))
        print("dragged" if drag else "free", rows)


if __name__ == "__main__":
    main()
