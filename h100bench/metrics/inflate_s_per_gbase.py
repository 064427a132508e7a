"""Host reader: seconds in the native reader's decoder (zlib's gzread, or
libdeflate where it is built; the `inflate_ns` of the port's
`reader.block` spans) in the traced jobs, per Gbase they read."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    blocks = sp.named(rec, "reader.block") if rec else []
    if not blocks:
        return None
    return sp.per_gbase(run, sp.total(blocks, "inflate_ns") / 1e9)
