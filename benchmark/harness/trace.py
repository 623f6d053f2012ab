"""Reading torch.profiler's Chrome trace: device activity as a union of
intervals, the benchmark's own spans, and the host thread's time outside
the calls that wait for the device. Times in the trace are microseconds;
what this module returns is in seconds."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

# Published HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet), at the
# full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
# Host calls that block until the device has done its work: the time the
# host thread spends in them is waiting, not host work.
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
         "cudaStreamWaitEvent", "cuStreamSynchronize", "cuCtxSynchronize")


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name, tid)
    spans: dict = field(default_factory=lambda: defaultdict(list))

    @property
    def main_tid(self):
        frames = [h for h in self.host if h[2] == "bench.frame"]
        return frames[0][3] if frames else None

    def window(self):
        """(start, end) from the first frame span's start to the last
        one's end."""
        f = self.spans["bench.frame"]
        return (min(s for s, _ in f), max(e for _, e in f)) if f else None


def parse(events: list) -> Trace:
    t = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"]) * 1e-6
        end = s + float(e.get("dur", 0.0)) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            t.device.append((s, end, e.get("name", "")))
        elif cat in HOST_CATS:
            t.host.append((s, end, e.get("name", ""), e.get("tid")))
            if cat == "user_annotation" and e.get("name", "").startswith(
                    "bench."):
                t.spans[e["name"]].append((s, end))
    return t


def load(path) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return parse(data["traceEvents"] if isinstance(data, dict) else data)


def union(intervals) -> list:
    """The merged, sorted intervals covering `intervals` [(start, end)]."""
    out = []
    for s, e in sorted((iv[0], iv[1]) for iv in intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(merged) -> float:
    return sum(e - s for s, e in merged)


def overlap(merged, windows) -> float:
    """Total length of `merged` (disjoint, sorted) inside `windows`."""
    total, k = 0.0, 0
    for ws, we in union(windows):
        while k < len(merged) and merged[k][1] <= ws:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < we:
            total += min(merged[j][1], we) - max(merged[j][0], ws)
            j += 1
    return total


def device_busy(t: Trace, windows) -> float:
    """Seconds in which some device operation ran, inside `windows`."""
    return overlap(union(t.device), windows)


def host_work(t: Trace, windows) -> float:
    """The main thread's seconds inside `windows`, less its seconds in
    calls that wait for the device (WAITS)."""
    tid = t.main_tid
    waits = union((s, e) for s, e, name, th in t.host
                  if th == tid and name in WAITS)
    spans = union(windows)
    return length(spans) - overlap(waits, spans)


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device in the traced window, each named by the innermost
    host event on the main thread at the gap's middle."""
    by_name = defaultdict(float)
    for s, e, name in t.device:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    win = t.window()
    gaps = []
    if win:
        busy = union(t.device)
        edges = [win[0]] + [x for s, e in busy for x in (s, e)] + [win[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, win[0]), min(b, win[1])
            if b > a:
                gaps.append((a, b))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    tid = t.main_tid
    host = [h for h in t.host if h[3] == tid]

    def label(mid):
        inside = [h for h in host if h[0] <= mid <= h[1]]
        if not inside:
            return "host: between events"
        s, e, name, _ = min(inside, key=lambda h: h[1] - h[0])
        return f"host: {name}"

    return {
        "device_ops": [[name[:160], sec] for name, sec in ops],
        "idle_gaps": [[label((a + b) / 2), b - a] for a, b in gaps],
    }
