"""Seeded input generators of the benchmark (see benchmark/__init__.py)."""
