"""The program's own spans in the harness's parsed trace: the `sph.` ranges
that `sph_tpu_torch.utils.profiling.span` opens around each phase of the
colony step and around each blocking host read. Everything here is on the
main thread and inside the traced `bench.steps` spans; times in seconds.

Device operation → span, by launch order: on one stream the card runs
operations in the order the host enqueued them, so the i-th device
operation in start order is the one the main thread's i-th enqueue call
(ENQUEUE) made, and it belongs to the innermost `sph.` span holding that
call. The pairing stands only where the two counts are equal and each pair
is of one kind: a copy call with a copy, a set with a set, a launch with a
kernel (a pairing shifted by one breaks that at the next copy or set).
Start times are not compared: the trace's card clock drifts microseconds
from the host's. Where the pairing does not stand nothing is attributed.
On a trace with no `sph.` span (a program without them) every reading is
None.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.harness.trace import overlap, union

PREFIX = "sph."
READ = "sph.read."
# Host calls that put one operation on the card's queue: kernel launches,
# asynchronous copies and sets.
ENQUEUE = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize")


def _kind(name: str) -> str:
    """"copy", "set" or "kernel", alike for a call and its operation."""
    if "Memcpy" in name:
        return "copy"
    return "set" if "Memset" in name else "kernel"


def _by_start(events):
    """Sorted by start, the longer first where two start together, so that
    a parent comes before its child."""
    return sorted(events, key=lambda h: (h[0], -h[1]))


@dataclass
class Phases:
    steps: list      # [(start, end)] the traced bench.steps spans
    spans: list      # [(start, end, name)] the main thread's sph. spans
    calls: list      # [(start, end, name)] its enqueue calls
    ops: list        # [(start, end, name)] device operations, start order
    host: list       # [(start, end, name)] every main-thread host event
    paired: bool     # the launch-order pairing stands

    def in_steps(self, t: float) -> bool:
        return any(s <= t <= e for s, e in self.steps)

    def launched(self, windows) -> list:
        """The device operations whose enqueue call starts inside one of
        `windows` [(start, end)]; [] where the pairing does not stand."""
        if not self.paired:
            return []
        w = union(windows)
        out, k = [], 0
        for call, op in zip(self.calls, self.ops):
            while k < len(w) and w[k][1] < call[0]:
                k += 1
            if k < len(w) and w[k][0] <= call[0]:
                out.append(op)
        return out

    def named(self, name: str) -> list:
        """[(start, end)] the spans called `name` that start inside the
        step spans."""
        return [(s, e) for s, e, n in self.spans
                if n == name and self.in_steps(s)]


def read_phases(t) -> Phases | None:
    """The spans, calls and operations of a parsed Trace; None where the
    trace holds no sph. span."""
    tid = t.main_tid
    host = _by_start((s, e, n) for s, e, n, th in t.host if th == tid)
    spans = [h for h in host if h[2].startswith(PREFIX)]
    if not spans:
        return None
    calls = [h for h in host if h[2] in ENQUEUE]
    ops = sorted(t.device)
    paired = (len(calls) == len(ops)
              and all(_kind(call[2]) == _kind(op[2])
                      for call, op in zip(calls, ops)))
    return Phases(steps=sorted(t.spans["bench.steps"]), spans=spans,
                  calls=calls, ops=ops, host=host, paired=paired)


def innermost(spans, points) -> list:
    """For each time in `points` (ascending), the index into `spans`
    (properly nested, in _by_start order) of the innermost span holding
    it, or None."""
    out, stack, k = [], [], 0
    for x in points:
        while k < len(spans) and spans[k][0] <= x:
            while stack and spans[stack[-1]][1] <= spans[k][0]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]][1] < x:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def device_s(ph: Phases, name: str):
    """Device seconds of the operations launched inside the spans called
    `name` (their child spans included) in the step spans; None where the
    pairing does not stand or no operation was launched in the steps."""
    if not ph.launched(ph.steps):
        return None
    return sum(e - s for s, e, _ in ph.launched(ph.named(name)))


def reads(ph: Phases) -> int:
    """sph.read.* spans that start inside the step spans."""
    return sum(1 for s, _, n in ph.spans
               if n.startswith(READ) and ph.in_steps(s))


def idle_gaps(ph: Phases) -> list:
    """[(start, end)] the device's idle intervals inside the step spans,
    ascending."""
    busy = union((s, e) for s, e, _ in ph.ops)
    gaps = []
    for ws, we in ph.steps:
        edges = [ws] + [x for s, e in busy if e > ws and s < we
                        for x in (s, e)] + [we]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, ws), min(b, we)
            if b > a:
                gaps.append((a, b))
    return gaps


def read_idle_s(ph: Phases):
    """Device idle seconds inside the step spans in gaps that begin while
    the main thread is inside a sph.read.* span (the queue ran dry because
    the host waited on a read); None where no device operation ran in the
    steps."""
    if overlap(union((s, e) for s, e, _ in ph.ops), ph.steps) <= 0:
        return None
    rd = [(s, e) for s, e, n in ph.spans if n.startswith(READ)]
    gaps = idle_gaps(ph)
    held = innermost(rd, [a for a, _ in gaps])
    return sum(b - a for (a, b), i in zip(gaps, held) if i is not None)
