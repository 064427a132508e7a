"""Bloom admission: the least time of the traced jobs' pass-1 admission
(bloom_work: 80 bytes a valid lane, summed over their `yak.bloom`
spans' `lanes`, at the card's memory rate) over the profiled device
time of the admission's kernels (csrc/bloom.cu), %."""

from h100bench import bloom_work, roofline
from h100bench import yak_spans as ys


def read(run):
    got = ys.jobs(run)
    peak = roofline.peaks(run.device_name)
    t = sum(s.device_s(*bloom_work.KERNELS) for s in run.summaries)
    if got is None or peak is None or t <= 0:
        return None
    lanes = sum(int(s.attrs["lanes"]) for by in got
                for s in by.get("yak.bloom", []))
    return 100.0 * bloom_work.admission_bytes(lanes) \
        / peak["hbm_bytes_per_s"] / t
