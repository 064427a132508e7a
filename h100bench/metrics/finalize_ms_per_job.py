"""Finalize: a job's wall after its last count loop (seghist's
histogram, counts_for, the output written), mean over the window's
jobs, ms."""


def read(run):
    v = [j.finalize_s for j in run.jobs if j.finalize_s is not None]
    return 1e3 * sum(v) / len(v) if v else None
