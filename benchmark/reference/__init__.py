"""Plain references of the benchmark (see benchmark/__init__.py)."""
