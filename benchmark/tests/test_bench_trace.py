"""The trace arithmetic on a synthetic trace: union of device intervals,
idle share, host time less waits, the breakdown, and both byte counts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import spec, trace


def ev(cat, name, ts_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "tid": tid, "pid": 1}


def synthetic():
    """Two frames of 1 ms; device busy 0.1-0.4 and 0.3-0.5 (overlapping
    streams) and 1.2-1.5 ms; the host waits 0.6-0.9 ms in a synchronise."""
    return trace.parse([
        ev("user_annotation", "bench.frame", 0, 1000),
        ev("user_annotation", "bench.steps", 0, 1000),
        ev("user_annotation", "bench.frame", 1000, 1000),
        ev("user_annotation", "bench.steps", 1000, 1000),
        ev("kernel", "k_a", 100, 300, tid=7),
        ev("kernel", "k_b", 300, 200, tid=8),
        ev("gpu_memcpy", "Memcpy DtoH", 1200, 300, tid=7),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", 600, 300),
        ev("cpu_op", "aten::nonzero", 1500, 400),
        ev("gpu_user_annotation", "bench.frame", 0, 2000, tid=7),
    ])


def test_union_merges_overlaps():
    assert trace.union([(3, 4), (0, 2), (1, 2.5)]) == [[0, 2.5], [3, 4]]
    assert trace.length(trace.union([(0, 1), (0.5, 2)])) == 2


def test_overlap_clips_to_windows():
    merged = trace.union([(0, 1), (2, 3)])
    assert trace.overlap(merged, [(0.5, 2.5)]) == pytest.approx(1.0)
    assert trace.overlap(merged, [(0.5, 0.7), (2.9, 5)]) == pytest.approx(
        0.3)


def test_device_busy_is_a_union_not_a_sum():
    t = synthetic()
    win = t.window()
    assert win == pytest.approx((0.0, 2e-3))
    # 0.1-0.5 ms (k_a and k_b overlap) and 1.2-1.5 ms; the GPU-side copy
    # of the annotation is not device work.
    assert trace.device_busy(t, [win]) == pytest.approx(0.7e-3)


def test_idle_share_reader():
    read = spec.metric_reader("idle_share.colony")
    ctx = SimpleNamespace(trace=synthetic())
    assert read(ctx) == pytest.approx(100 * (1 - 0.7 / 2.0))


def test_host_time_excludes_waits():
    t = synthetic()
    spans = t.spans["bench.steps"]
    assert trace.host_work(t, spans) == pytest.approx(2e-3 - 0.3e-3)
    read = spec.metric_reader("host_ms_per_step.colony")
    ctx = SimpleNamespace(trace=t, traced_steps=20)
    assert read(ctx) == pytest.approx(1.7 / 20)


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(synthetic())
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.3e-3)]
    assert len(b["device_ops"]) == 3
    gaps = dict((round(s * 1e6), name) for name, s in b["idle_gaps"])
    # Idle 0.5-1.2 ms (the host in its synchronise at 0.85 ms) and
    # 1.5-2.0 ms (the host in aten::nonzero at 1.75 ms).
    assert gaps[700] == "host: cudaStreamSynchronize"
    assert gaps[500] == "host: aten::nonzero"


@pytest.mark.parametrize("units, bonds, least_bytes", [
    (1000, 0, 104 * 1000),
    (1000, 500, 104 * 1000 + 32 * 500),
])
def test_byte_counts(units, bonds, least_bytes):
    t = synthetic()
    busy = trace.device_busy(t, t.spans["bench.steps"])
    ctx = SimpleNamespace(trace=t, units=units, bonds=bonds, traced_steps=1)
    share = spec.metric_reader("step_roofline.colony")(ctx)
    assert share == pytest.approx(
        100 * least_bytes / trace.HBM_BYTES_PER_S / busy)


def test_roofline_reader_is_silent_without_device_work():
    t = trace.parse([ev("user_annotation", "bench.steps", 0, 10)])
    ctx = SimpleNamespace(trace=t, units=10, bonds=0, traced_steps=1)
    assert spec.metric_reader("step_roofline.colony")(ctx) is None
