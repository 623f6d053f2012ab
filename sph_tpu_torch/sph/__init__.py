"""WCSPH fluid model, scenes and the dense cell-grid engine (PyTorch)."""
