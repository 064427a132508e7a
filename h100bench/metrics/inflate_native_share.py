"""Host reader: the share of the text the native reader served in the
traced jobs that its own DEFLATE decoder produced (the `inflate_bytes`
over the `text_bytes` of the port's `reader.block` spans), %: 100 where
every input was gzip that the decoder took whole.  None on a port whose
spans do not count `inflate_bytes` (its reader ran zlib's gzread)."""

from h100bench import spans as sp


def read(run):
    rec = sp.traced(run)
    blocks = sp.named(rec, "reader.block") if rec else []
    if not blocks or any("inflate_bytes" not in s.attrs for s in blocks):
        return None
    text = sp.total(blocks, "text_bytes")
    return 100.0 * sp.total(blocks, "inflate_bytes") / text if text else None
