"""ed-vaf-counter's reader and batching: the share of the traced jobs'
bases that came through the native reader (`edvaf.file`'s
`native_bases` over its `bases`), %.  None on a port whose spans do not
count `native_bases`."""

from h100bench import edvaf_spans as es
from h100bench import spans as sp


def read(run):
    got = es.jobs(run)
    files = es.files(got) if got else []
    if not files or any("native_bases" not in s.attrs for s in files):
        return None
    bases = sp.total(files, "bases")
    return 100.0 * sp.total(files, "native_bases") / bases if bases else None
