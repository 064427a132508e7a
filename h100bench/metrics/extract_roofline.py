"""Extraction kernel: the least time its work needs at the card's
memory rate (each base read once, an 8-byte key written a k-mer
position: roofline.extract_bytes) over the profiled device time of the
extract kernels, in the traced jobs, %."""

from h100bench import roofline


def read(run):
    peak = roofline.peaks(run.device_name)
    t = sum(s.device_s("extract_kernel") for s in run.summaries)
    if peak is None or t <= 0:
        return None
    k = run.cell.config["k"]
    nbytes = sum(roofline.extract_bytes(*run.inputs.files[i].reads.shape, k)
                 for j in run.traced for i in j.files)
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / t
