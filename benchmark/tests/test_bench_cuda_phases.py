"""On the card: a traced run of each listed cell at a test size reports
the metrics that read the program's spans, every launch paired with its
device operation. Skips without a card.

    python -m pytest --noconftest -q -m cuda benchmark/tests/test_bench_cuda_phases.py
"""

from __future__ import annotations

import time

import pytest

from benchmark.tests.test_bench_cuda import _small, card  # noqa: F401

SPAN_METRICS = ("adhesion_ms_per_step.colony", "contact_ms_per_step.colony",
                "host_reads_per_step.colony", "read_idle_ms_per_step.colony")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["colony_1m"])
def test_traced_run_reads_the_spans(card, name, tmp_path):  # noqa: F811
    from benchmark.harness import phases, trace
    from benchmark.run import run_cell

    res = run_cell(_small(name), 4000000103, 1.0, True, dev="cuda",
                   t0=time.perf_counter(), out=lambda msg: None,
                   trace_dir=tmp_path)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(got.get(m) is not None for m in SPAN_METRICS), got
    assert got["adhesion_ms_per_step.colony"] > 0
    assert got["contact_ms_per_step.colony"] > 0
    # 4,096 cells take the plain adhesion sum: five reads a quiet step.
    assert got["host_reads_per_step.colony"] == 5.0
    assert phases.read_phases(trace.load(tmp_path / "trace.json")).paired
