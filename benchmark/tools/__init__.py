"""One-time tools of the benchmark (see benchmark/__init__.py)."""
