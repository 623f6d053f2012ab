"""Core datatypes, quaternions and initialisation (PyTorch)."""

from sph_tpu_torch.core import quat  # noqa: F401
from sph_tpu_torch.core.types import (  # noqa: F401
    BondTable,
    Genome,
    GenomeDevice,
    GenomeMode,
    PendingSplits,
    SimParams,
    SimState,
)
