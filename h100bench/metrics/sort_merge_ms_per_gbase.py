"""Compactor and merges: profiled device time of the radix sorts
(torch.sort's CUB kernels) and the merge-path kernels (merge_partition*,
merge_path*) in the traced jobs, ms per Gbase they read."""

NEEDLES = ("RadixSort", "merge_partition", "merge_path")


def read(run):
    t = sum(s.device_s(*NEEDLES) for s in run.summaries)
    gb = run.bases(run.traced) / 1e9
    return 1e3 * t / gb if t > 0 and gb > 0 else None
