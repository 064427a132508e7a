"""Host reader: seconds in the native reader's block calls outside the
decoder (the record scan, the copy into the block, the 2-bit pack:
`native_ns - inflate_ns` of the port's `reader.block` spans) in the
traced jobs, per Gbase they read."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    blocks = sp.named(rec, "reader.block") if rec else []
    if not blocks:
        return None
    ns = sp.total(blocks, "native_ns") - sp.total(blocks, "inflate_ns")
    return sp.per_gbase(run, ns / 1e9)
