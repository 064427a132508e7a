"""Tools: the median job wall over the window's jobs, s."""

import statistics


def read(run):
    return statistics.median(j.wall for j in run.jobs) if run.jobs else None
