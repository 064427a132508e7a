"""Compactor and merges: budget trips that fold new counted runs into a
standing plane (the port's `compactor.fold` spans inside an
`ingest.dispatch` span of the main thread, at any depth) per traced
job; 0 where none ran.  A job's first trip finds no standing plane and
folds none; a fold at the end of a count (the histogram's, counts_for's)
is finalize's, not a trip's.  A port whose compactor has no fold
(`table/compactor.py` `fold`) records no such span: None."""

from h100bench import spans as sp


def read(run):
    try:
        from kmer_tpu_torch.table import compactor
    except ImportError:
        return None
    if not hasattr(compactor, "fold"):
        return None
    rec = sp.traced(run)
    if rec is None:
        return None
    by_id = {s.id: s for s in rec}
    dispatch = {s.id for s in sp.named(rec, "ingest.dispatch",
                                       main_thread=True)}

    def in_dispatch(s):
        while s.parent in by_id:
            if s.parent in dispatch:
                return True
            s = by_id[s.parent]
        return False

    folds = sum(in_dispatch(s) for s in sp.named(rec, "compactor.fold",
                                                 main_thread=True))
    return folds / len(run.traced)
