"""Staging and dispatch: wall of the port's `reader.stage` spans (a
block's arrays wrapped as tensors and copied into pinned memory, in the
reader thread) in the traced jobs, per Gbase they read."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    stages = sp.named(rec, "reader.stage") if rec else []
    if not stages:
        return None
    return sp.per_gbase(run, sp.wall_s(stages))
