"""Two-file yak-count's pass 2 (reader, extraction, every key into the
second compactor): the wall of the traced jobs' pass-2 `yak.pass` spans
over the bases that pass read, s per Gbase."""

from h100bench import yak_spans as ys


def read(run):
    return ys.s_per_gbase(ys.jobs(run), 2)
