"""Tools: wall of vaf-counter's pattern-file load (the port's
`vaf.patterns` span), mean over the traced jobs, ms."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    got = sp.named(rec, "vaf.patterns") if rec else []
    if not got:
        return None
    return 1e3 * sp.wall_s(got) / len(run.traced)
