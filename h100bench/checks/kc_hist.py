"""kc-c4's stdout: 255 rows `i<TAB>n`, n the distinct canonical k-mers
seen i times (i = 255: 255 times or more).  The control counts 32-bit
fingerprints of the keys instead."""

from h100bench.reference import kmers

N_BINS = 256


def expected(inputs, cell, keys, device, control=False):
    """{"jobs": {a job's inputs (indices into inputs.files; kc-c4 reads
    one): its stdout}}."""
    out = {}
    for key in keys:
        _, counts = kmers.key_counts(kmers.reads_keys(
            inputs.files[key[0]].reads, cell.config["k"], device, control))
        out[key] = kmers.hist_rows(counts, N_BINS)
        del counts
    return {"jobs": out}
