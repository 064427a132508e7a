"""Two-file yak-count's shrink (both compactors' last compaction, the
join of the pass-1 keys against the pass-2 counts, the histogram): the
wall of the traced jobs' `yak.shrink` spans, mean a job, ms."""

from h100bench import spans as sp
from h100bench import yak_spans as ys


def read(run):
    got = ys.jobs(run)
    if not got:
        return None
    return 1e3 * sp.wall_s([s for by in got
                            for s in by.get("yak.shrink", [])]) / len(got)
