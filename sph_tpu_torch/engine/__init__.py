"""Host-facing simulation APIs (PyTorch)."""
