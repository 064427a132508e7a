"""Compactor and merges: wall of the port's budget-trip compactions (its
`compactor.compact` spans inside an `ingest.dispatch` span of the main
thread; each ends in the compaction's own synchronization) in the
traced jobs, per Gbase they read; 0 where none ran.  A compaction at
the end of a count (the histogram's, or counts_for's) is finalize's,
not dispatch's."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    if rec is None:
        return None
    dispatch = {s.id for s in sp.named(rec, "ingest.dispatch",
                                       main_thread=True)}
    return sp.per_gbase(run, sp.wall_s(
        s for s in sp.named(rec, "compactor.compact", main_thread=True)
        if s.parent in dispatch))
