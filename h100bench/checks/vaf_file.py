"""vaf-counter's VAF file for each sample, and snp-pattern-gen's pattern
file that set-up wrote.  The control cuts the reads' and the patterns'
k-mers to 32-bit fingerprints."""

from h100bench.reference import snp


def expected(inputs, cell, keys, device, control=False):
    """{"jobs": {a job's inputs (one sample): VAF text}, "setup":
    {"patterns": text}}."""
    k = cell.config["k"]
    rows = snp.patterns(inputs.extra, k, device)
    jobs = {key: snp.vaf_text(inputs.extra, rows, inputs.files[key[0]].reads,
                              k, device, control)
            for key in keys}
    return {"jobs": jobs,
            "setup": {"patterns": snp.pattern_text(inputs.extra, rows)}}
