"""WCSPH fluid model, scenes and the dense cell-grid engine (PyTorch)."""

from sph_tpu_torch.sph.model import SPHParams, SPHState, sph_step, make_sph_step  # noqa: F401
from sph_tpu_torch.sph.scenes import dam_break_2d, dam_break_3d, splash_pour_2d  # noqa: F401
