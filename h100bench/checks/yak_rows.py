"""yak-count on one file with a bloom filter: its stdout (1023 rows)
then its `[M` stderr lines, both passes and the shrink.  The control
cuts the hashed k-mers to 32-bit fingerprints."""

from h100bench.reference import yak


def got(job):
    return job.text + "".join(line + "\n" for line in job.err.splitlines()
                              if line.startswith("[M"))


def expected(inputs, cell, keys, device, control=False):
    """{"jobs": {a job's inputs (one file): stdout and `[M` lines}}."""
    p = cell.traffic["params"]
    return {"jobs": {key: yak.expected(inputs.files[key[0]].reads,
                                       cell.config["k"], p["prefix_bits"],
                                       p["bloom_bits"], p["hashes"],
                                       p["chunk"], device, control)
                     for key in keys}}
