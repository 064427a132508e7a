"""`fold_trips_per_job` against a store of the port's spans built by
hand (the jobs, runs and span helper of test_h100bench_port_spans.py):
it counts the `compactor.fold` spans under a main-thread
`ingest.dispatch` span, at any depth, per traced job; a fold at the end
of a count, in another thread or outside the traced jobs does not
count; no fold reads 0, and a port without the fold reads None."""

import pytest

from h100bench.spec import load_module
from h100bench.tests.test_h100bench_port_spans import MAIN, _run, _span

NAME = "fold_trips_per_job"


def _child(name, t0, t1, parent, thread=MAIN, **attrs):
    s = _span(name, t0, t1, thread=thread, **attrs)
    s.parent = parent.id
    return s


def _job(lo, folds):
    """One job's spans from lo: a count loop with one dispatch, in it
    `folds` budget trips that each fold into the standing plane and one
    trip that finds none; a fold at finalize, after the loop; a fold in
    another thread."""
    loop = _span("count.loop", lo + 1.0, lo + 8.0, lanes_added=200)
    dispatch = _child("ingest.dispatch", lo + 5.0, lo + 7.6, loop)
    first = _child("compactor.compact", lo + 5.0, lo + 5.1, dispatch)
    out = [loop, dispatch, first]
    for i in range(folds):
        trip = _child("compactor.compact", lo + 5.2 + 0.5 * i,
                      lo + 5.6 + 0.5 * i, dispatch)
        out += [trip, _child("compactor.fold", lo + 5.3 + 0.5 * i,
                             lo + 5.5 + 0.5 * i, trip,
                             standing_lanes=50, new_lanes=20)]
    final = _span("compactor.compact", lo + 8.6, lo + 9.0)
    other = _span("compactor.compact", lo + 6.0, lo + 6.5, thread=1)
    out += [final, other,
            _child("compactor.fold", lo + 8.7, lo + 8.9, final),
            _child("compactor.fold", lo + 6.1, lo + 6.4, other, thread=1)]
    return out


def _read(monkeypatch, store, traced=True):
    from kmer_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(store))
    return load_module("metrics", NAME).read(_run(traced))


@pytest.mark.parametrize("folds, want", [((2, 2), 2.0), ((3, 1), 2.0),
                                         ((0, 0), 0.0)])
def test_counts_trip_folds_per_traced_job(monkeypatch, folds, want):
    """Two traced jobs ([10, 20] and [30, 40]), a fold in the untraced
    third: the folds under each dispatch, over two jobs."""
    store = (_job(10.0, folds[0]) + _job(30.0, folds[1])
             + _job(50.0, 4))
    got = _read(monkeypatch, store)
    assert got == want and isinstance(got, float)


def test_nothing_traced_reads_none(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, _job(10.0, 2), traced=False) is None


def test_a_port_without_the_fold_reads_none(monkeypatch):
    """A port whose compactor has no `fold` records no `compactor.fold`
    span: the count says nothing, rather than 0."""
    from kmer_tpu_torch.table import compactor

    monkeypatch.delattr(compactor, "fold")
    assert _read(monkeypatch, _job(10.0, 2) + _job(30.0, 2)) is None
