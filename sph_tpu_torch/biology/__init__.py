"""Division and the adhesion bond graph (PyTorch)."""

from sph_tpu_torch.biology.bonds import (  # noqa: F401
    ZONE_A,
    ZONE_B,
    ZONE_C,
    classify_zone,
    filter_bonds,
    handle_cell_split,
    update_bond_zones,
)
from sph_tpu_torch.biology.division import (  # noqa: F401
    process_pending_splits,
    queue_splits,
)
