"""Verification, profiling and state-conversion helpers."""

from sph_tpu_torch.utils.profiling import step_breakdown, trace  # noqa: F401
