"""Division and the adhesion bond graph (PyTorch)."""
