"""Compactor and merges: lanes the compactor sorted or merged (the
`lanes_sorted` of its `compactor.sort` and `compactor.merge` spans: the
stream ladder, the compactions, the final plane) per lane appended to
it (the `lanes_added` of the `count.loop` spans), in the traced
jobs."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    if rec is None:
        return None
    added = sp.total(sp.named(rec, "count.loop"), "lanes_added")
    if added <= 0:
        return None
    done = sum(sp.total(sp.named(rec, n), "lanes_sorted")
               for n in ("compactor.sort", "compactor.merge"))
    return done / added
