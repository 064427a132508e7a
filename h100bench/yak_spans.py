"""Two-file yak-count's own spans (kmer_tpu_torch/pipeline/yak.py
SortYakEngine: `yak.pass`, `yak.bloom`, `yak.shrink`) of the traced
jobs, for the metrics that read them (metrics/yak_*.py,
metrics/bloom_roofline.py).

SortYakEngine runs no SortCountEngine count loop, so its jobs have no
Job.stats and spans.traced finds no bounds for them.  Its jobs are told
apart by their own spans instead: in the main thread each job opens
with its pass-1 `yak.pass` span.  The tracer records while the traced
stretch's profiler runs and not after it, so the traced jobs are the
last len(run.traced) jobs the store holds; earlier ones are an earlier
run's in the same process.  Each is checked against its job: its two
passes' `bases` add up to what the job's inputs hold.  A port without
these spans, a store that dropped spans, or a job that does not check
gives None."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from h100bench import spans as sp


def jobs(run) -> Optional[List[Dict[str, list]]]:
    """For each of run.traced's jobs, its yak spans by name, or None."""
    try:
        from kmer_tpu_torch.utils import trace
    except ImportError:  # a port that records no span
        return None
    if trace.dropped() or not run.traced:
        return None
    main = threading.main_thread().ident
    rec = sorted((s for s in trace.spans()
                  if s.name.startswith("yak.") and s.thread == main),
                 key=lambda s: s.t0)
    starts = [i for i, s in enumerate(rec)
              if s.name == "yak.pass" and s.attrs.get("pass") == 1]
    if len(starts) < len(run.traced):
        return None
    groups = [rec[a:b] for a, b in zip(starts, starts[1:] + [len(rec)])]
    out = []
    for job, group in zip(run.traced, groups[-len(run.traced):]):
        by: Dict[str, list] = {}
        for s in group:
            by.setdefault(s.name, []).append(s)
        bases = sp.total(by["yak.pass"], "bases")
        if len(by["yak.pass"]) != 2 or bases != run.bases([job]):
            return None
        out.append(by)
    return out


def passes(got, n: int) -> list:
    """The traced jobs' `yak.pass` spans of pass n."""
    return [s for by in got for s in by["yak.pass"]
            if s.attrs.get("pass") == n]


def s_per_gbase(got, n: int) -> Optional[float]:
    """Pass n's wall over the bases it read, s per Gbase, or None."""
    if not got:
        return None
    p = passes(got, n)
    gb = sp.total(p, "bases") / 1e9
    return sp.wall_s(p) / gb if gb > 0 else None
