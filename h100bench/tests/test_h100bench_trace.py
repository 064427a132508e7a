"""The trace arithmetic: busy time as a union of intervals, idle gaps by
the host span, device time by kernel; and the extract work count."""

from h100bench import roofline, trace


def test_union_merges_overlaps_once():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)]) == \
        [(0, 3), (5, 9), (10, 11)]
    assert trace.union([]) == []


def test_gaps_and_clip():
    busy = trace.union(trace.clip([(0, 4), (6, 8), (9, 20)], 2, 12))
    assert busy == [(2, 4), (6, 8), (9, 12)]
    assert trace.gaps(busy, 2, 12) == [(4, 6), (8, 9)]
    assert trace.gaps([], 0, 3) == [(0, 3)]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_counts_overlap_once_and_labels_gaps():
    events = [
        _ev("user_annotation", "bench.job", 0, 100),
        _ev("user_annotation", "bench.ingest", 10, 60),
        _ev("user_annotation", "bench.job", 120, 80),
        _ev("kernel", "void extract_kernel<31>(unsigned char const*)", 20,
            10),
        _ev("gpu_memcpy", "Memcpy HtoD", 25, 10),  # overlaps the kernel
        _ev("kernel", "DeviceRadixSortOnesweepKernel", 80, 10),
        _ev("kernel", "merge_path<S64>", 130, 20),
        _ev("cpu_op", "aten::sort", 0, 500),  # host events are not busy
    ]
    s = trace.summarize(events)
    assert s.window_s == 200e-6
    assert abs(s.busy_s - 45e-6) < 1e-12  # 20-35, 80-90, 130-150
    assert abs(s.device_s("extract_kernel") - 10e-6) < 1e-12
    assert abs(s.device_s("RadixSort", "merge_path") - 30e-6) < 1e-12
    # gaps 0-20, 35-80, 90-130, 150-200, cut at the spans' bounds
    want = {"prelude": 10, "ingest": 10 + 35, "finalize": 10 + 10,
            "between_jobs": 20, "job": 10 + 50}  # job 2 has no loop
    assert set(s.idle_by_span) == set(want)
    for name, us in want.items():
        assert abs(s.idle_by_span[name] - us * 1e-6) < 1e-12, name
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "merge_path"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_no_jobs_no_busy():
    s = trace.summarize([_ev("kernel", "k", 0, 5)])
    assert s.busy_s == 0.0 and s.window_s == 0.0


def test_extract_work_count():
    # each base read once, 8 bytes a k-mer position
    assert roofline.extract_bytes(5_000_000, 100, 31) == \
        500_000_000 + 8 * 70 * 5_000_000
    assert roofline.extract_bytes(10, 20, 31) == 200
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == \
        3.35e12
    assert roofline.peaks("some other card") is None


def test_short_names():
    assert trace.short_name("void merge_path<S64>(GlobalRun<long>, long)") \
        == "merge_path"
    assert trace.short_name(
        "void at::native::(anonymous namespace)::fill<long>(long*)") == \
        "at::native::fill"
    assert trace.short_name("at_cuda_detail::cub::DeviceRadixSortOnesweep"
                            "Kernel<Policy, false>(int*)") == \
        "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel"
