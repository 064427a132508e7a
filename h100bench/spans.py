"""The port's own spans (kmer_tpu_torch/utils/trace.py), for the
per-layer metrics that read them (metrics/<name>.py).

The port's tracer records while a profiler runs, so in a traced run it
holds the traced stretch's spans, and maybe spans of an earlier run in
the same process.  `traced` keeps only the spans that lie inside the
traced jobs, each job from its first count loop's start less its
prelude to its last loop's end plus its finalize (Job.stats, prelude_s,
finalize_s: the harness's perf_counter clock, the tracer's).  A port
without the tracer, a store that dropped spans (past its CAPACITY: the
sums would fall short), or no span inside those jobs, gives None."""

from __future__ import annotations

import threading


def traced(run):
    """The port's spans inside run.traced's jobs, or None."""
    try:
        from kmer_tpu_torch.utils import trace
    except ImportError:  # a port that records no span
        return None
    if trace.dropped():
        return None
    bounds = [(min(s["t_begin"] for s in j.stats) - j.prelude_s,
               max(s["t_end"] for s in j.stats) + j.finalize_s)
              for j in run.traced if j.stats]
    got = [s for s in trace.spans()
           if any(a <= s.t0 and s.t1 <= b for a, b in bounds)]
    return got or None


def named(spans, name: str, main_thread: bool = False):
    """The spans called `name` (those of the main thread alone)."""
    main = threading.main_thread().ident
    return [s for s in spans if s.name == name
            and (not main_thread or s.thread == main)]


def wall_s(spans) -> float:
    return float(sum(s.t1 - s.t0 for s in spans))


def total(spans, key: str) -> float:
    return float(sum(s.attrs.get(key, 0) for s in spans))


def per_gbase(run, seconds: float):
    """Seconds per Gbase the traced jobs read, or None."""
    gb = run.bases(run.traced) / 1e9
    return seconds / gb if gb > 0 else None
