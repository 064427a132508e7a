"""Host reader: IngestStats.reader_s (inflate, parse, pack, in the
reader thread) summed over the window's count loops, per Gbase read."""


def read(run):
    if not any(j.stats for j in run.jobs):
        return None
    return run.stat("reader_s") / (run.bases() / 1e9)
