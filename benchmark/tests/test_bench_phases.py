"""The program's spans read from a synthetic trace: device operations tied
to the span their launch was made in by launch order, the reads, and the
idle they cause; every reader silent where it cannot attribute, and on a
trace without the program's spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import phases, spec, trace

NEW = ("adhesion_ms_per_step.colony", "contact_ms_per_step.colony",
       "host_reads_per_step.colony", "read_idle_ms_per_step.colony")
ATTRIBUTED = NEW[:2]


def ev(cat, name, ts_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "tid": tid, "pid": 1}


def api(name, ts_us, dur_us):
    cat = "cuda_driver" if name.startswith("cuL") else "cuda_runtime"
    return ev(cat, name, ts_us, dur_us)


def step_events():
    """One frame of one step, 0-1000 us. Launches: contact's kernel at 30
    (runs 50-150), the pair math's at 230 (240-400), the accumulate's at
    310 (400-450, through the driver API), the read's copy at 520
    (530-540). The device is idle 0-50, 150-240, 450-530
    (begun in sph.adhesion.accumulate) and 540-1000 (begun in
    sph.read.ready)."""
    return [
        ev("user_annotation", "bench.frame", 0, 1000),
        ev("user_annotation", "bench.steps", 0, 1000),
        ev("user_annotation", "sph.step", 10, 890),
        ev("user_annotation", "sph.contact", 20, 180),
        api("cudaLaunchKernel", 30, 5),
        ev("user_annotation", "sph.adhesion", 210, 290),
        ev("user_annotation", "sph.adhesion.pairs", 220, 80),
        api("cudaLaunchKernel", 230, 5),
        ev("user_annotation", "sph.adhesion.accumulate", 300, 190),
        api("cuLaunchKernel", 310, 10),
        ev("user_annotation", "sph.bonds", 500, 300),
        ev("user_annotation", "sph.read.ready", 510, 190),
        api("cudaMemcpyAsync", 520, 10),
        api("cudaStreamSynchronize", 530, 160),
        ev("kernel", "contact_kernel", 50, 100, tid=7),
        ev("kernel", "pair_kernel", 240, 160, tid=7),
        ev("kernel", "scan_kernel", 400, 50, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH", 530, 10, tid=7),
        ev("gpu_user_annotation", "sph.adhesion", 240, 210, tid=7),
    ]


def ctx_of(events, steps=1):
    return SimpleNamespace(trace=trace.parse(events), traced_steps=steps)


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_ops_go_to_the_span_that_launched_them():
    ctx = ctx_of(step_events())
    ph = phases.read_phases(ctx.trace)
    assert ph.paired and len(ph.calls) == 4
    # The pair math's and the accumulate's kernels, in child spans.
    assert read("adhesion_ms_per_step.colony", ctx) == pytest.approx(0.21)
    assert read("contact_ms_per_step.colony", ctx) == pytest.approx(0.1)
    ctx.traced_steps = 2
    assert read("adhesion_ms_per_step.colony", ctx) == pytest.approx(0.105)


def test_reads_are_counted_in_the_step_spans():
    events = step_events() + [
        # A read outside the benchmark's step spans does not count.
        ev("user_annotation", "sph.read.plan", 1500, 10)]
    assert read("host_reads_per_step.colony", ctx_of(events)) == 1.0
    events += [ev("user_annotation", "sph.read.young", 600, 10)]
    assert read("host_reads_per_step.colony", ctx_of(events, 2)) == 1.0


def test_read_idle_is_the_gaps_begun_in_a_read():
    # Only the gap 540-1000 begins inside sph.read.ready.
    ctx = ctx_of(step_events())
    assert read("read_idle_ms_per_step.colony", ctx) == pytest.approx(0.46)
    gaps = phases.idle_gaps(phases.read_phases(ctx.trace))
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in gaps] == [
        (0, 50), (150, 240), (450, 530), (540, 1000)]
    # The same gap begun outside the read: no read idle.
    moved = [dict(e, ts=700) if e["name"] == "sph.read.ready" else e
             for e in step_events()]
    assert read("read_idle_ms_per_step.colony",
                ctx_of(moved)) == pytest.approx(0.0)


@pytest.mark.parametrize("fault", ["extra op", "missing launch",
                                   "kinds differ"])
def test_unpaired_launches_attribute_nothing(fault):
    events = step_events()
    if fault == "extra op":
        events.append(ev("kernel", "stray_kernel", 600, 10, tid=7))
    elif fault == "missing launch":
        events = [e for e in events if e["ts"] != 230]
    else:
        # A kernel recorded where the copy ran, the copy dropped: the
        # counts agree, the kinds do not.
        events = [ev("kernel", "stray_kernel", 530, 10, tid=7)
                  if e["name"] == "Memcpy DtoH" else e for e in events]
    ctx = ctx_of(events)
    assert not phases.read_phases(ctx.trace).paired
    for name in ATTRIBUTED:
        assert read(name, ctx) is None, name
    # The readers that need no pairing still read.
    assert read("host_reads_per_step.colony", ctx) == 1.0


def test_pairing_ignores_the_card_clocks_drift():
    """An operation stamped a few microseconds before its launch (the
    card's clock drifting from the host's) still pairs."""
    events = [dict(e, ts=e["ts"] - 236) if e["cat"] in ("kernel",
                                                       "gpu_memcpy") else e
              for e in step_events()]
    ctx = ctx_of(events)
    assert phases.read_phases(ctx.trace).paired
    assert read("contact_ms_per_step.colony", ctx) == pytest.approx(0.1)


def test_every_reader_is_silent_without_the_programs_spans():
    """The parent's trace: the benchmark's spans, launches and kernels,
    and no sph. span."""
    events = [e for e in step_events()
              if not e["name"].startswith("sph.")]
    ctx = ctx_of(events)
    assert phases.read_phases(ctx.trace) is None
    for name in NEW:
        assert read(name, ctx) is None, name


def test_attribution_needs_device_work():
    """A trace of the CPU route: spans and reads, no launch, no kernel."""
    events = [e for e in step_events()
              if e["cat"] in ("user_annotation", "cpu_op")]
    ctx = ctx_of(events)
    for name in ATTRIBUTED + ("read_idle_ms_per_step.colony",):
        assert read(name, ctx) is None, name
    assert read("host_reads_per_step.colony", ctx) == 1.0


def test_innermost_span():
    spans = [(0, 10, "a"), (1, 5, "b"), (2, 3, "c"), (6, 9, "d")]
    assert phases.innermost(spans, [0.5, 2.5, 4, 7, 9.5, 11]) == [
        0, 2, 1, 3, 0, None]


def test_the_tool_prints_every_span(capsys, tmp_path):
    import json

    from benchmark.tools import phases as tool

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": step_events()}))
    assert tool.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "| `sph.adhesion` | 1 | 0.2100 | 0.0000 |" in out
    assert "| `sph.adhesion.pairs` | 1 | 0.1600 | 0.1600 |" in out
    assert "of them outside sph.read.*: 0" in out
    assert "device ops matched %: 100.0" in out
