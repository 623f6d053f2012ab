"""Contact, drag, integration and adhesion passes of the colony step (PyTorch)."""

from sph_tpu_torch.physics.contact import contact_forces_bruteforce  # noqa: F401
from sph_tpu_torch.physics.integrate import update_motion, update_rotation  # noqa: F401
from sph_tpu_torch.physics.adhesion import apply_adhesion  # noqa: F401
from sph_tpu_torch.physics.drag import apply_drag_force  # noqa: F401
