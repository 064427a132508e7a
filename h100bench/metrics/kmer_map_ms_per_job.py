"""Tools: wall of vaf-counter's k-mer map (the port's `vaf.kmer_map`
span: create_combined_kmer_map), mean over the traced jobs, ms."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    got = sp.named(rec, "vaf.kmer_map") if rec else []
    if not got:
        return None
    return 1e3 * sp.wall_s(got) / len(run.traced)
