"""Traffic drivers of the benchmark (see benchmark/__init__.py)."""
