"""The per-layer metrics that read the port's own spans
(kmer_tpu_torch/utils/trace.py, through spans.py) against a store built
by hand: spans outside the traced jobs' bounds are ignored, an empty
store, a store that dropped spans or a port without the tracer reads
None, and a stretch with no budget trip reads 0."""

import sys
import threading

import numpy as np
import pytest

from h100bench import gen, harness
from h100bench.spec import load_module
from h100bench.tests.helpers import small_cell

NAMES = ["inflate_s_per_gbase", "parse_s_per_gbase", "stage_s_per_gbase",
         "compact_s_per_gbase", "compactor_lanes_per_lane",
         "pattern_load_ms_per_job", "kmer_map_ms_per_job"]
MAIN = threading.main_thread().ident


def _span(name, t0, t1, thread=MAIN, **attrs):
    from kmer_tpu_torch.utils import trace

    s = trace.Span(name, None, attrs)
    s.t0, s.t1, s.thread = t0, t1, thread
    return s


def _job(lo, hi):
    """A job from lo to hi seconds, its one count loop from lo + 1 to
    hi - 2."""
    j = harness.Job("kc-c4", [], (0,))
    j.stats = [{"t_begin": lo + 1.0, "t_end": hi - 2.0}]
    j.prelude_s, j.finalize_s = 1.0, 2.0
    return j


def _run(traced):
    """Two traced jobs, [10, 20] and [30, 40], each reading a file of
    0.5 Gbases, and a third one after the traced stretch."""
    reads = np.broadcast_to(np.zeros(1, np.uint8), (5_000_000, 100))
    inputs = gen.Inputs([gen.ReadSet("/in/a.fa.gz", reads)], [])
    jobs = [_job(10.0, 20.0), _job(30.0, 40.0), _job(50.0, 60.0)]
    return harness.Run(small_cell("mabs_kc_c4"), inputs, jobs,
                       jobs[:2] if traced else [], [], "cpu")


def _in_job(lo, trips=True):
    """One job's spans, starting at lo: 1 s of inflate and 2 of parse,
    0.25 s of staging, a 1.5 s budget trip in a dispatch (when `trips`),
    compactions that are not one (in another thread, and at the end,
    outside every dispatch), 300 lanes sorted and 100 merged for 200
    added, a 0.1 s pattern load and a 0.2 s k-mer map."""
    dispatch = _span("ingest.dispatch", lo + 5.0, lo + 7.6)
    out = [
        _span("vaf.patterns", lo + 0.1, lo + 0.2),
        _span("vaf.kmer_map", lo + 0.3, lo + 0.5),
        _span("count.loop", lo + 1.0, lo + 8.0, lanes_added=200),
        _span("reader.block", lo + 1.0, lo + 4.0, thread=1,
              inflate_ns=10**9, native_ns=3 * 10**9),
        _span("reader.stage", lo + 4.0, lo + 4.25, thread=1, bytes=10),
        dispatch,
        _span("compactor.sort", lo + 5.0, lo + 5.5, lanes_sorted=300),
        _span("compactor.merge", lo + 5.5, lo + 6.0, lanes_sorted=100),
        _span("compactor.compact", lo + 6.0, lo + 6.5, thread=1),
        _span("compactor.compact", lo + 8.6, lo + 9.0),
    ]
    if trips:
        out.append(_span("compactor.compact", lo + 6.0, lo + 7.5))
        out[-1].parent = dispatch.id
    return out


# what would change every metric if it counted: before the first job,
# between the jobs, astride a job's end, in the untraced job after
OUTSIDE = [
    _span(name, t0, t1, thread=thread, **attrs)
    for t0, t1 in ((5.0, 6.0), (24.0, 25.0), (19.5, 20.5), (51.0, 52.0))
    for name, thread, attrs in (
        ("reader.block", 1, {"inflate_ns": 10**12, "native_ns": 10**13}),
        ("reader.stage", 1, {"bytes": 1}),
        ("compactor.compact", MAIN, {}),
        ("compactor.sort", MAIN, {"lanes_sorted": 10**9}),
        ("count.loop", MAIN, {"lanes_added": 1}),
        ("vaf.patterns", MAIN, {}), ("vaf.kmer_map", MAIN, {}))]


def _read(monkeypatch, store, traced=True):
    from kmer_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(store))
    run = _run(traced)
    return {n: load_module("metrics", n).read(run) for n in NAMES}


def test_reads_only_the_traced_jobs(monkeypatch):
    got = _read(monkeypatch, OUTSIDE + _in_job(10.0) + _in_job(30.0))
    # 1 Gbase read in the two traced jobs
    assert got == pytest.approx({
        "inflate_s_per_gbase": 2.0, "parse_s_per_gbase": 4.0,
        "stage_s_per_gbase": 0.5, "compact_s_per_gbase": 3.0,
        "compactor_lanes_per_lane": 2.0,
        "pattern_load_ms_per_job": 100.0, "kmer_map_ms_per_job": 200.0})
    assert all(isinstance(v, float) for v in got.values())


def test_no_budget_trip_reads_zero(monkeypatch):
    got = _read(monkeypatch, _in_job(10.0, False) + _in_job(30.0, False))
    assert got["compact_s_per_gbase"] == 0.0
    assert got["inflate_s_per_gbase"] == pytest.approx(2.0)


@pytest.mark.parametrize("store, traced", [
    ([], True),  # nothing recorded
    (OUTSIDE, True),  # nothing inside the traced jobs
    (_in_job(10.0), False),  # no traced stretch
])
def test_nothing_to_read_reads_none(monkeypatch, store, traced):
    assert _read(monkeypatch, store, traced) == dict.fromkeys(NAMES)


def test_a_store_that_dropped_spans_reads_none(monkeypatch):
    """Past the store's CAPACITY the oldest spans go: the sums of what
    is left would fall short, so every reader says nothing."""
    from kmer_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "dropped", lambda: 1)
    assert _read(monkeypatch, _in_job(10.0) + _in_job(30.0)) == \
        dict.fromkeys(NAMES)


def test_a_port_without_the_tracer_reads_none(monkeypatch):
    """A port from before the tracer: the import fails, every reader
    says nothing and raises nothing."""
    import kmer_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "kmer_tpu_torch.utils.trace", None)
    monkeypatch.delattr(kmer_tpu_torch.utils, "trace", raising=False)
    run = _run(True)
    assert {n: load_module("metrics", n).read(run) for n in NAMES} == \
        dict.fromkeys(NAMES)
