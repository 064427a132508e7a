"""Staging and dispatch: the share of the count loops' wall in which the
main thread waited on the reader (IngestStats.wait_s / loop_s), %."""


def read(run):
    loop = run.stat("loop_s")
    return 100.0 * run.stat("wait_s") / loop if loop > 0 else None
