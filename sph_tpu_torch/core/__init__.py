"""Core datatypes, quaternions and initialisation (PyTorch)."""
