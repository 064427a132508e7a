"""Two-file yak-count's pass 1 (reader, extraction, the bloom's
admission, the admitted keys compacted a batch): the wall of the traced
jobs' pass-1 `yak.pass` spans over the bases that pass read, s per
Gbase."""

from h100bench import yak_spans as ys


def read(run):
    return ys.s_per_gbase(ys.jobs(run), 1)
