"""sph_tpu_torch — the PyTorch + CUDA port of sph_tpu.

The same framework on an NVIDIA H100: soft-sphere contact dynamics with
rigid-body rotation, genome-driven cell division with an adhesion bond
graph, WCSPH fluids on a spatial-hash grid or the dense cell grid,
spatial domain decomposition over torch.distributed ranks, point-splat
rendering and the host services around them (checkpoints, recovery, the
viewer and the app CLI, the benchmark ladder in `bench.py`).

Mirrors `sph_tpu`'s layout and namespaces, so every module has one
counterpart to be held against. The Pallas kernels become hand-written
CUDA kernels for Hopper (`csrc/`, built at first use by `ops/build.py`,
wrapped in `ops/`). Imports no JAX: the JAX package stays the reference
and only the tests import both.
"""

__version__ = "0.1.0"

from sph_tpu_torch.core.types import (  # noqa: F401
    Genome,
    GenomeMode,
    SimParams,
    SimState,
)
from sph_tpu_torch.engine.simulation import Simulation  # noqa: F401
