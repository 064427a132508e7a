"""Two-file yak-count given one read set under two names: its stdout
(1023 rows) then its `[M` stderr lines, both passes and the shrink,
against the plain reference of any bloom size (reference/yak_wide.py).
The control clamps the bloom to 2^31 bits."""

import numpy as np

from h100bench.reference import yak_wide


def got(job):
    """stdout then the `[M` lines of stderr; a job whose stderr is its
    text (the control's, control.py) has them there already."""
    if job.err is job.text:
        return job.text
    return job.text + "".join(line + "\n" for line in job.err.splitlines()
                              if line.startswith("[M"))


def expected(inputs, cell, keys, device, control=False):
    """{"jobs": {a job's inputs (two names of one file): stdout and `[M`
    lines}}."""
    p = cell.traffic["params"]
    out = {}
    for key in keys:
        reads = [inputs.files[i].reads for i in key]
        assert all(r is reads[0] or np.array_equal(r, reads[0])
                   for r in reads), "a job's inputs hold different reads"
        out[key] = yak_wide.expected(reads[0], cell.config["k"],
                                     p["prefix_bits"], p["bloom_bits"],
                                     p["hashes"], p["chunk"], device,
                                     control)
    return {"jobs": out}
