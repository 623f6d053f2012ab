"""The port's spans (utils.profiling.span): a shared no-op with no profiler
recording; under one, each phase of the colony step once a step, nested
in `sph.step`, and each blocking host read in its own `sph.read.*` span
(six a quiet step on the planned adhesion path, five on the plain one, as
engine/step.py's docstring counts them); a division step's reads too; and
the state after the steps bitwise the same with and without the profiler.
"""

import dataclasses
import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sph_tpu_torch.engine.colony import bonded_colony
from sph_tpu_torch.engine.config import (
    reference_genome,
    reference_scene_params,
)
from sph_tpu_torch.engine.simulation import Simulation
from sph_tpu_torch.utils import profiling
from sph_tpu_torch.utils.profiling import span

torch.set_num_threads(2)

STEPS = 4
PHASES = ("sph.division", "sph.contact", "sph.contact.pack",
          "sph.contact.sweep", "sph.contact.gather", "sph.adhesion",
          "sph.adhesion.pairs",
          "sph.adhesion.accumulate", "sph.motion", "sph.bonds")
# Each span's parent, by name.
PARENT = {
    "sph.division": "sph.step", "sph.contact": "sph.step",
    "sph.adhesion": "sph.step", "sph.motion": "sph.step",
    "sph.bonds": "sph.step",
    "sph.contact.pack": "sph.contact", "sph.contact.sweep": "sph.contact",
    "sph.contact.gather": "sph.contact",
    "sph.adhesion.pairs": "sph.adhesion",
    "sph.adhesion.accumulate": "sph.adhesion",
    "sph.read.pending": "sph.division", "sph.read.ready": "sph.division",
    "sph.read.splits": "sph.division",
    "sph.read.changed": "sph.adhesion.accumulate",
    "sph.read.segment": "sph.adhesion.accumulate",
    "sph.read.young": "sph.bonds", "sph.read.dirty": "sph.bonds",
    "sph.read.plan": "sph.plan.check", "sph.read.active": "sph.contact",
}
QUIET_READS = {
    "on": ("pending", "ready", "changed", "young", "dirty", "plan"),
    "off": ("pending", "ready", "segment", "young", "dirty"),
}


def colony(plan: str) -> Simulation:
    st, p, g = bonded_colony(256, device="cpu", use_pallas=True,
                             adhesion_plan=plan)
    sim = Simulation(g, p, device="cpu", scan_chunk=2)
    sim.state = st
    return sim


def traced(run, path) -> list:
    """[(start, end, name)] the sph. spans of a profiled `run()`, read
    back from its exported Chrome trace, parents before children."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("sph.")]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def parent_of(spans, i):
    """The name of the innermost span holding span i, or None."""
    s, e, _ = spans[i]
    holders = [sp for j, sp in enumerate(spans)
               if j != i and sp[0] <= s and e <= sp[1]]
    return min(holders, key=lambda sp: sp[1] - sp[0])[2] if holders else None


def flat(obj, prefix=""):
    """Every tensor of a (nested) state dataclass, by field path."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
    return out


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("sph.a") is span("sph.b")
    with span("sph.a"):
        with span("sph.b"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="sph.c"):
            span("sph.c")


def test_span_records_under_a_profiler(tmp_path):
    def run():
        with span("sph.x"):
            torch.ones(4).sum()

    spans = traced(run, tmp_path / "t.json")
    assert [n for _, _, n in spans] == ["sph.x"]
    assert span("sph.y") is profiling._NO_SPAN


@pytest.mark.parametrize("plan", ["on", "off"])
def test_colony_step_spans(plan, tmp_path):
    sim = colony(plan)
    spans = traced(lambda: sim.run(STEPS), tmp_path / "t.json")
    names = Counter(n for _, _, n in spans)
    assert names["sph.step"] == STEPS
    for name in PHASES:
        assert names[name] == STEPS, name
    reads = {n[len("sph.read."):]: c for n, c in names.items()
             if n.startswith("sph.read.")}
    assert reads == {r: STEPS for r in QUIET_READS[plan]}
    # The run's first plan, built by Simulation before its first chunk.
    assert names["sph.plan.build"] == (1 if plan == "on" else 0)
    assert names["sph.plan.check"] == (STEPS if plan == "on" else 0)
    for i, (_, _, name) in enumerate(spans):
        assert parent_of(spans, i) == PARENT.get(name), name
    # Each step's reads: those in it and the plan check right after it.
    steps = [sp for sp in spans if sp[2] == "sph.step"]
    ends = [sp[0] for sp in steps[1:]] + [float("inf")]
    for (s, _, _), end in zip(steps, ends):
        n = sum(1 for a, _, name in spans
                if name.startswith("sph.read.") and s <= a < end)
        assert n == len(QUIET_READS[plan])


def test_division_step_reads_are_spanned(tmp_path):
    """The reference scene's first division (queued at step 50 with dt
    0.1) applies its split with the host reads of `_apply_splits`, in one
    span inside sph.division."""
    p = reference_scene_params(capacity=8, dt=0.1, max_splits_per_step=4,
                               neighbor_mode="bruteforce")
    sim = Simulation(reference_genome(), p, device="cpu", scan_chunk=1)
    sim.run(49)
    assert int(sim.state.active_count) == 1
    spans = traced(lambda: sim.run(3), tmp_path / "t.json")
    assert int(sim.state.active_count) == 2
    names = Counter(n for _, _, n in spans)
    assert names["sph.read.splits"] == 1
    # The brute-force contact reads its live count.
    assert names["sph.read.active"] == 3
    i = [n for _, _, n in spans].index("sph.read.splits")
    assert parent_of(spans, i) == "sph.division"


@pytest.mark.parametrize("plan", ["on", "off"])
def test_profiler_leaves_the_state_bitwise(plan, tmp_path):
    plain, seen = colony(plan), colony(plan)
    plain.run(STEPS)
    traced(lambda: seen.run(STEPS), tmp_path / "t.json")
    a, b = flat(plain.state), flat(seen.state)
    assert a.keys() == b.keys() and "bonds.active" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k
