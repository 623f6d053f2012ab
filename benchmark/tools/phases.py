"""The program's spans in one traced run, span by span, and the checks that
the attribution is whole:

    python -m benchmark.tools.phases build/benchmark/<cell>/trace.json

For each `sph.` span name, per step (a step is one `sph.step` span inside
the traced `bench.steps` spans): calls; device ms of the operations
launched inside it, child spans included and then its own alone; host
self ms (the span less its child spans and less its calls that wait for
the device); operations launched, child spans included. Then the checks:
the device operations that pair with an enqueue call (all or none),
synchronise calls in `sph.step` or `sph.plan.*` outside every
`sph.read.*` span, the share of step idle whose gap middle lies in a
`sph.` span, and the share of step device time launched inside one.
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from benchmark.harness import phases, trace


def parents(spans) -> list:
    """Per span (in phases._by_start order), the index of its parent."""
    out, stack = [], []
    for i, (s, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(i)
    return out


def table(ph: phases.Phases) -> tuple[int, list]:
    """(steps, rows): per span name, [name, calls, device ms incl., device
    ms self, host self ms, ops], each per step."""
    spans = [sp for sp in ph.spans if ph.in_steps(sp[0])]
    steps = sum(1 for sp in spans if sp[2] == "sph.step")
    par = parents(spans)
    rows = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0])
    self_host = [e - s for s, e, _ in spans]
    for i, p in enumerate(par):
        if p is not None:
            self_host[p] -= spans[i][1] - spans[i][0]
    waits = [h for h in ph.host if h[2] in trace.WAITS]
    for w, i in zip(waits, phases.innermost(spans, [w[0] for w in waits])):
        if i is not None:
            self_host[i] -= w[1] - w[0]
    paired = ph.launched(ph.steps)
    calls = [c for c in ph.calls if ph.in_steps(c[0])]
    owner = phases.innermost(spans, [c[0] for c in calls])
    dev_self = defaultdict(float)
    ops_in = defaultdict(int)
    dev_in = defaultdict(float)
    for op, i in zip(paired, owner):
        j = i
        if i is not None:
            dev_self[i] += op[1] - op[0]
        while j is not None:
            dev_in[j] += op[1] - op[0]
            ops_in[j] += 1
            j = par[j]
    for i, (_, _, name) in enumerate(spans):
        r = rows[name]
        r[0] += 1
        r[1] += dev_in[i]
        r[2] += dev_self[i]
        r[3] += self_host[i]
        r[4] += ops_in[i]
    n = max(steps, 1)
    return steps, [[name, r[0] / n, 1e3 * r[1] / n, 1e3 * r[2] / n,
                    1e3 * r[3] / n, r[4] / n] for name, r in rows.items()]


def checks(ph: phases.Phases) -> dict:
    """The attribution's checks, inside the step spans."""
    launched = ph.launched(ph.steps)
    rd = [(s, e) for s, e, n in ph.spans if n.startswith(phases.READ)]
    outer = [(s, e) for s, e, n in ph.spans
             if n == "sph.step" or n.startswith("sph.plan.")]
    syncs = [h for h in ph.host if h[2] in phases.SYNCS]
    syncs = [h for h, i in zip(syncs, phases.innermost(
        outer, [h[0] for h in syncs])) if i is not None]
    stray = [h for h, i in zip(syncs, phases.innermost(
        rd, [h[0] for h in syncs])) if i is None]
    gaps = phases.idle_gaps(ph)
    held = phases.innermost(ph.spans, [(a + b) / 2 for a, b in gaps])
    idle = sum(b - a for a, b in gaps)
    busy = sum(e - s for s, e, _ in launched)
    owned = ph.launched([(s, e) for s, e, _ in ph.spans if ph.in_steps(s)])
    return {
        "enqueue calls, whole trace": len(ph.calls),
        "device ops, whole trace": len(ph.ops),
        "device ops matched %": (100.0 * ph.paired if ph.ops else None),
        "device ops launched in the steps": len(launched),
        "syncs in sph.step or sph.plan.*": len(syncs),
        "of them outside sph.read.*": len(stray),
        "step idle ms": 1e3 * idle,
        "of it with the gap middle in a sph. span %": (
            100.0 * sum(b - a for (a, b), i in zip(gaps, held)
                        if i is not None) / idle if idle else None),
        "device ms launched in the steps": 1e3 * busy,
        "of it launched in a sph. span %": (
            100.0 * sum(e - s for s, e, _ in owned) / busy if busy
            else None),
        "read idle ms": 1e3 * (phases.read_idle_s(ph) or 0.0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    args = ap.parse_args(argv)
    t = trace.load(args.trace)
    ph = phases.read_phases(t)
    if ph is None:
        print("no sph. span in the trace")
        return 1
    steps, rows = table(ph)
    print(f"{args.trace}: {steps} steps")
    print("| span | calls | device ms | device ms, own | host self ms "
          "| ops |")
    print("|---|---|---|---|---|---|")
    for name, calls, dev, own, host, ops in sorted(rows):
        print(f"| `{name}` | {calls:g} | {dev:.4f} | {own:.4f} | "
              f"{host:.4f} | {ops:g} |")
    print(f"checks, over the {steps} traced steps:")
    for k, v in checks(ph).items():
        if isinstance(v, float) and k.endswith(" ms"):
            v = f"{v:.4f} ({v / max(steps, 1):.4f} a step)"
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
