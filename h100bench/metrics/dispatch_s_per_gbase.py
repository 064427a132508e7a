"""Staging and dispatch: IngestStats.dispatch_s (main-thread time issuing
the copy, extraction and compactor work, throttle waits included) per
Gbase read."""


def read(run):
    if not any(j.stats for j in run.jobs):
        return None
    return run.stat("dispatch_s") / (run.bases() / 1e9)
