"""Contact, drag, integration and adhesion passes of the colony step (PyTorch)."""
