"""Host-facing simulation APIs (PyTorch)."""

from sph_tpu_torch.engine.step import step  # noqa: F401
from sph_tpu_torch.engine.simulation import Simulation  # noqa: F401
