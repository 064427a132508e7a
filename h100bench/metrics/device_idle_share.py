"""Device: 1 - (union of the card's kernel, copy and memset intervals) /
the profiled stretch of whole jobs, averaged over the cards, %."""


def read(run):
    s = [x for x in run.summaries if x.window_s > 0]
    if not s:
        return None
    return 100.0 * (1.0 - sum(x.busy_s / x.window_s for x in s) / len(s))
