"""The bloom admission's work, counted from the inputs, for
`bloom_roofline`: the least traffic of one valid pass-1 lane is its
8-byte key read, the 64-byte bloom block that holds all its probes read
(written back only where a bit is new, which is not counted), and the
8-byte admitted key (the key, or the sentinel) written, as two-file
yak-count's `bloom.admit` writes it.  Counted from the lanes, the share
reads the same work whatever implements the admission.

The time is the device time of the admission's kernels, by name: the
port's csrc/bloom.cu launches these three and no other kernel inside a
`yak.bloom` span (tests/test_torch_cuda.py holds it to that).  The
trace's reduction (trace.py) keeps device time by kernel name and no
launch-to-kernel correlation, so the kernels cannot be found as those
launched inside the span."""

KEY_BYTES = 8
BLOCK_BYTES = 64
ADMITTED_BYTES = 8
LANE_BYTES = KEY_BYTES + BLOCK_BYTES + ADMITTED_BYTES  # 80
KERNELS = ("bloom_clear_kernel", "bloom_probe_kernel", "bloom_admit_kernel")


def admission_bytes(lanes: int) -> int:
    """The least traffic of admitting `lanes` valid lanes."""
    return LANE_BYTES * int(lanes)
