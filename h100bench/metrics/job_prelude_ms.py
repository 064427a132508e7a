"""Tools: a job's wall before its first count loop (arguments, the
pattern file's load and the k-mer map), mean over the window's jobs,
ms."""


def read(run):
    v = [j.prelude_s for j in run.jobs if j.prelude_s is not None]
    return 1e3 * sum(v) / len(v) if v else None
