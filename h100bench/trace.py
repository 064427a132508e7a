"""Reduce a torch.profiler Chrome trace to the benchmark's device
numbers: the device's busy time as the union of its kernel, copy and
memset intervals (overlaps count once), its idle gaps labelled by the
benchmark's own host span that was open when each began, and device
time by kernel name."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def gaps(busy, lo: float, hi: float):
    """The idle intervals of [lo, hi] outside the disjoint busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without return type, template and argument
    lists, at most 96 letters: `void f<int>(int*)` -> `f`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()[:96]


@dataclass
class Summary:
    window_s: float  # the traced stretch: first job start to last job end
    busy_s: float  # union of device intervals within it
    kernel_s: Dict[str, float]  # device seconds by full kernel name
    op_s: Dict[str, float]  # device seconds by short name, copies too
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def device_s(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any needle."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(n in name for n in needles))


class _Spans:
    """The benchmark's host spans of a trace: jobs, and the count loops
    (`ingest`) inside them."""

    def __init__(self, spans):
        self.jobs = sorted((a, b) for a, b, n in spans if n == "job")
        self.ingest = sorted((a, b) for a, b, n in spans if n == "ingest")
        self.bounds = sorted({t for a, b in self.jobs + self.ingest
                              for t in (a, b)})

    def label(self, t: float) -> str:
        """What the host was doing at t: in a count loop (`ingest`), in a
        job before its first loop (`prelude`), after its last
        (`finalize`), between loops or in a job without one (`job`), or
        between jobs."""
        i = bisect.bisect_right(self.jobs, (t, float("inf"))) - 1
        if i < 0 or t >= self.jobs[i][1]:
            return "between_jobs"
        a, b = self.jobs[i]
        loops = [(x, y) for x, y in self.ingest if x >= a and y <= b]
        if any(x <= t < y for x, y in loops):
            return "ingest"
        if not loops:
            return "job"
        if t < loops[0][0]:
            return "prelude"
        if t >= loops[-1][1]:
            return "finalize"
        return "job"

    def pieces(self, a: float, b: float):
        """[a, b) cut at every span boundary inside it."""
        i = bisect.bisect_right(self.bounds, a)
        cuts = [a]
        while i < len(self.bounds) and self.bounds[i] < b:
            cuts.append(self.bounds[i])
            i += 1
        cuts.append(b)
        return zip(cuts, cuts[1:])


def summarize(events: list) -> Summary:
    """From a Chrome trace's event list (torch.profiler's export)."""
    dev, spans = [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    op_s: Dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((a, b))
            name = ev.get("name", cat)
            op_s[short_name(name) if cat == "kernel" else cat] += \
                (b - a) / 1e6
            if cat == "kernel":
                kernel_s[name] += (b - a) / 1e6
        elif cat == "user_annotation" and \
                ev.get("name", "").startswith(SPAN_PREFIX):
            spans.append((a, b, ev["name"][len(SPAN_PREFIX):]))
    host = _Spans(spans)
    if not host.jobs or not dev:
        return Summary(0.0, 0.0, dict(kernel_s), dict(op_s))
    lo, hi = host.jobs[0][0], max(b for _, b in host.jobs)
    busy = union(clip(dev, lo, hi))
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps(busy, lo, hi):
        for x, y in host.pieces(a, b):
            idle[host.label(x)] += (y - x) / 1e6
    return Summary((hi - lo) / 1e6, sum(b - a for a, b in busy) / 1e6,
                   dict(kernel_s), dict(op_s), dict(idle))


def load(path: str) -> Summary:
    with open(path) as f:
        data = json.load(f)
    return summarize(data["traceEvents"] if isinstance(data, dict)
                     else data)


def breakdown(s: Summary, top: int = 10) -> dict:
    ops = sorted(s.op_s.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(s.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
