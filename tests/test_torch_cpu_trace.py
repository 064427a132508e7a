"""The port's tracer (kmer_tpu_torch/utils/trace.py) and the spans and
counters the port records with it, on the CPU: the spans of a kc-c4 job
and a vaf-counter job under torch.profiler, with their parents, the
reader thread's included; their `kmer.*` events in the Chrome trace;
nothing recorded and no record_function entered without a profiler;
the native reader's counters, one set a block call, nested as the
intervals they time, on both decoders; the compactor's lane counts
against a count made by hand; ed-vaf-counter's spans and their counts
against its inputs."""

import collections
import contextlib
import ctypes
import functools
import gzip
import io
import json
import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmer_tpu_torch.io import native
from kmer_tpu_torch.pipeline import counter
from kmer_tpu_torch.table import compactor
from kmer_tpu_torch.tools import ed_vaf_counter, get_tool, kc, vaf_counter
from kmer_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
BED = os.path.join(FIXTURES, "snps_small.bed")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")
BUDGET = 1 << 20  # a 10 Mbase block trips it at once: one compaction
LOOP_CHILDREN = {"reader.block", "reader.stage", "ingest.wait",
                 "ingest.dispatch"}
READER_SIDE = {"reader.block", "reader.stage"}


@pytest.fixture(autouse=True)
def _cpu_and_clean(monkeypatch):
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    trace.clear()
    yield
    trace.enable(False)
    trace.clear()


def _small_budget(monkeypatch, *tools):
    for mod in tools:
        monkeypatch.setattr(mod, "make_count_engine", functools.partial(
            counter.make_count_engine, budget_bytes=BUDGET))


def _run(name, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert get_tool(name)(argv) == 0


def _tree(rec):
    """{span name: Counter of its parents' names} and the spans by id."""
    by = {s.id: s for s in rec}
    out = collections.defaultdict(collections.Counter)
    for s in rec:
        out[s.name][by[s.parent].name if s.parent in by else None] += 1
    return out, by


def _check_loop(rec, by, loop):
    """The loop's children: the reader side in another thread, the waits
    and dispatches in the loop's own, a budget trip in a dispatch."""
    kids = [s for s in rec if s.parent == loop.id]
    assert {s.name for s in kids} == LOOP_CHILDREN
    for s in kids:
        assert (s.thread != loop.thread) == (s.name in READER_SIDE), s
        assert loop.t0 <= s.t0 <= s.t1 <= loop.t1, s
    trips = [s for s in rec if s.name == "compactor.compact"
             and s.parent in by and by[s.parent].parent == loop.id]
    assert trips and all(by[s.parent].name == "ingest.dispatch"
                         for s in trips)
    assert all(by[s.parent].t0 <= s.t0 <= s.t1 <= by[s.parent].t1
               for s in trips)


def test_job_spans_under_a_profiler(monkeypatch, tmp_path):
    """kc-c4 and vaf-counter, each a budget trip, under a profiler: every
    span, each under the span that caused it; the Chrome trace holds a
    `kmer.<name>` event for every span of the main thread."""
    _small_budget(monkeypatch, kc, vaf_counter)
    pat = str(tmp_path / "p.pat")
    _run("snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", pat])
    trace.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        _run("kc-c4", ["-k31", READS])
        _run("vaf-counter", ["-k21", "-p", pat, "-o",
                             str(tmp_path / "a.vaf"), A1])
    finally:
        prof.stop()
    rec = trace.spans()
    assert trace.dropped() == 0
    tree, by = _tree(rec)
    assert set(tree) == {"count.loop", "vaf.patterns", "vaf.kmer_map",
                         "compactor.compact", "compactor.sort",
                         *LOOP_CHILDREN}
    for name in ("count.loop", "vaf.patterns", "vaf.kmer_map"):
        assert tree[name] == {None: 2 if name == "count.loop" else 1}, name
    for name in LOOP_CHILDREN:
        assert set(tree[name]) == {"count.loop"}, name
    # a trip's sort under its compaction; the histogram and counts_for
    # read the standing plane that the trip left, with no sort of their own
    assert set(tree["compactor.sort"]) == {"compactor.compact"}
    loops = [s for s in rec if s.name == "count.loop"]
    for loop in loops:
        _check_loop(rec, by, loop)
    # vaf-counter's prelude: after kc-c4's loop, before its own
    pat, kmap = (next(s for s in rec if s.name == n)
                 for n in ("vaf.patterns", "vaf.kmer_map"))
    assert loops[0].t1 <= pat.t0 <= pat.t1 <= kmap.t0 <= kmap.t1 \
        <= loops[1].t0
    # the Chrome trace: one event a span of the main thread, by name
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = collections.Counter(e["name"] for e in events
                              if e.get("name", "").startswith(trace.PREFIX))
    main = threading.main_thread().ident
    want = collections.Counter(trace.PREFIX + s.name for s in rec
                               if s.thread == main)
    assert {n: got[n] for n in want} == want


def test_off_without_a_profiler(monkeypatch):
    """No profiler and no enable(): nothing recorded, record_function
    never entered, the same output."""
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace._profiler, "record_function", Spy)
    _small_budget(monkeypatch, kc)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert get_tool("kc-c4")(["-k31", READS]) == 0
    assert trace.spans() == [] and entered == []
    assert len(out.getvalue().splitlines()) == 255
    assert trace.span("x") is trace.NULL
    with trace.timed("x") as t:
        pass
    assert not t and t.seconds >= 0 and trace.spans() == []


def test_enable_records_without_a_profiler():
    trace.enable(True)
    with trace.span("a", n=1) as a:
        with trace.span("b") as b:
            b.set(m=2)
    with trace.span("c", parent=trace.NULL) as c:
        pass
    assert not c
    assert [(s.name, s.parent, s.attrs) for s in trace.spans()] == [
        ("b", a.id, {"m": 2}), ("a", None, {"n": 1})]


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=4))
    trace.enable(True)
    for i in range(7):
        with trace.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in trace.spans()] == [3, 4, 5, 6]
    assert trace.dropped() == 3


def _reader_spans(it_fn, path):
    trace.enable(True)
    with trace.span("count.loop") as loop:
        for _ in it_fn([path], 21, 1 << 15, (1 << 15) + 4096, None, loop):
            pass
    blocks = [s for s in trace.spans() if s.name == "reader.block"]
    assert blocks and all(s.parent == loop.id for s in blocks)
    return blocks


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("path", [READS, GENOME])
def test_native_counters_are_exact(path, packed):
    """A file's reader.block spans: one a block call (each block, and
    the call that finds the end), each with exactly the counters'
    keys; the decoder's time is within the call's, and the call's
    within its span's (steady_clock and perf_counter are both the
    monotonic clock); every text byte of a gzip file came from the
    DEFLATE decoder."""
    if not native.available():
        pytest.skip("the native reader does not build here")
    fn = native.iter_packed2bit_native if packed else \
        native.iter_packed_native
    n_blocks = sum(1 for _ in fn([path], 21, 1 << 15, (1 << 15) + 4096))
    blocks = _reader_spans(fn, path)
    assert n_blocks >= 1 and len(blocks) == n_blocks + 1
    assert all(set(s.attrs) == {"inflate_ns", "native_ns", "inflate_bytes",
                                "text_bytes"} for s in blocks)
    assert all(0 <= s.attrs["inflate_ns"] <= s.attrs["native_ns"]
               <= (s.t1 - s.t0) * 1e9 for s in blocks)
    assert sum(s.attrs["inflate_ns"] for s in blocks) > 0
    text = sum(s.attrs["text_bytes"] for s in blocks)
    with gzip.open(path, "rb") as f:
        assert text == len(f.read())
    assert sum(s.attrs["inflate_bytes"] for s in blocks) == text


def test_native_counters_through_zlib(tmp_path):
    """The reader built from its two sources alone, with plain g++ and
    zlib (whose crc32 the decoder uses), whatever else the host has:
    the decoder's time within the block calls', and theirs within the
    reading's wall; its text bytes, all from the DEFLATE decoder."""
    so = str(tmp_path / "libzlibonly.so")
    srcs = [os.path.join(REPO, "kmer_tpu_torch", "io", "native", name)
            for name in ("fastx_reader.cpp", "gzinflate.cpp")]
    r = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", so, *srcs,
                        "-lz"], capture_output=True, timeout=120)
    if r.returncode != 0:
        pytest.skip("g++ and zlib do not build the reader here")
    lib = ctypes.CDLL(so)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ktp_open.restype = ctypes.c_void_p
    lib.ktp_open.argtypes = [ctypes.c_char_p]
    lib.ktp_close.argtypes = [ctypes.c_void_p]
    lib.ktp_read_block.restype = ctypes.c_int64
    lib.ktp_read_block.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.ktp_stats.restype = None
    lib.ktp_stats.argtypes = [ctypes.c_void_p, i64p]
    for path in (READS, GENOME):
        t0 = time.perf_counter()
        h = lib.ktp_open(path.encode())
        cap = 1 << 15
        buf = np.zeros(cap, np.uint8)
        out = [ctypes.c_int64() for _ in range(4)]
        calls = 0
        while lib.ktp_read_block(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                21, 1 << 14, *map(ctypes.byref, out)) > 0:
            calls += 1
        wall_ns = (time.perf_counter() - t0) * 1e9
        st = np.zeros(4, np.int64)
        lib.ktp_stats(h, st.ctypes.data_as(i64p))
        lib.ktp_close(h)
        assert calls >= 1
        assert 0 < st[0] <= st[1] <= wall_ns
        assert 0 < st[2] == st[3]


def test_loop_lanes_added_are_the_lanes_appended(monkeypatch):
    appended = []
    real = compactor.KmerCompactor.add_raw

    def add_raw(self, keys):
        appended.append(int(keys.shape[0]))
        return real(self, keys)

    monkeypatch.setattr(compactor.KmerCompactor, "add_raw", add_raw)
    eng = counter.SortCountEngine(k=21, block_bases=1 << 15, device="cpu")
    trace.enable(True)
    eng.count_paths([READS])
    loop, = [s for s in trace.spans() if s.name == "count.loop"]
    assert len(appended) > 1
    assert loop.attrs == {"lanes_added": sum(appended)}


def _trip_ladder():
    """A stream ladder of 1,024-lane chunks under a 20 KiB budget: the
    third chunk after a fold trips it (24 KiB)."""
    return compactor.KmerCompactor("cpu", budget_bytes=20 << 10,
                                   key_bits=42, stream_chunk=1024,
                                   stream_min=1024)


def _distinct_keys(n, seed=5):
    return torch.randperm(n, generator=torch.Generator().manual_seed(
        seed)).to(torch.int64) * 7919 + 11


def test_lanes_sorted_of_a_forced_trip():
    """Three chunks of distinct keys sort one each (3 x 1,024), the
    second merges with the first (2,048), and the third trips the
    budget: each ladder run compacts on its own, with no sort, and the
    two merge as (key, count) lanes into the first standing plane
    (3,072).  No standing plane was there, so no fold span.  3,072 lanes
    sorted and 5,120 merged for 3,072 added."""
    comp = _trip_ladder()
    keys = _distinct_keys(3 * 1024)
    trace.enable(True)
    for i in range(3):
        comp.add_raw(keys[i * 1024:(i + 1) * 1024])
    rec = trace.spans()
    trip, = [s for s in rec if s.name == "compactor.compact"]
    assert trip.attrs == {}
    sorts = [s.attrs["lanes_sorted"] for s in rec
             if s.name == "compactor.sort"]
    merges = [s for s in rec if s.name == "compactor.merge"]
    assert sorts == [1024, 1024, 1024]
    assert [s.attrs["lanes_sorted"] for s in merges] == [2048, 3072]
    assert merges[-1].parent == trip.id
    assert not [s for s in rec if s.name == "compactor.fold"]
    assert comp.last_n_unique == 3072 and comp._bytes == 0


def test_fold_span_of_a_later_trip():
    """After the first trip's plane (3,072 keys), three more chunks trip
    the budget again: 24 KiB of raw lanes since the fold, not the
    plane's bytes.  That trip folds the two new compacted runs (2,048
    and 1,024 distinct keys, half of them already in the plane) into the
    standing plane in one `compactor.fold` span under the trip, its
    counts the lanes it found, its merges smallest first beneath it."""
    comp = _trip_ladder()
    keys = _distinct_keys(3 * 1024)
    again = torch.cat([keys[:1536], (torch.arange(1536) + 3072) * 7919 + 11])
    again = again[torch.randperm(3072, generator=torch.Generator(
        ).manual_seed(6))]
    for i in range(3):
        comp.add_raw(keys[i * 1024:(i + 1) * 1024])
    trace.enable(True)
    for i in range(2):
        comp.add_raw(again[i * 1024:(i + 1) * 1024])
    assert comp._bytes == 16 << 10 and not [
        s for s in trace.spans() if s.name == "compactor.compact"]
    comp.add_raw(again[2048:])
    rec = trace.spans()
    trip, = [s for s in rec if s.name == "compactor.compact"]
    fold, = [s for s in rec if s.name == "compactor.fold"]
    assert fold.parent == trip.id
    assert fold.attrs == {"standing_lanes": 3072, "new_lanes": 3072}
    merges = [s for s in rec if s.name == "compactor.merge"
              and s.parent == fold.id]
    assert [s.attrs["lanes_sorted"] for s in merges] == [3072, 6144]
    assert comp.last_n_unique == 4608
    counts = comp.runs[0][1]
    assert int((counts == 2).sum()) == 1536 and int(counts.sum()) == 6144


def test_vaf_counter_synchronizes_only_under_v(monkeypatch, tmp_path):
    """-v ends a file's time after the engine's device work (a
    synchronization, a no-op on the CPU); without -v nothing changes."""
    calls = []
    real = vaf_counter._synchronize
    monkeypatch.setattr(vaf_counter, "_synchronize",
                        lambda eng: calls.append(real(eng)))
    pat = str(tmp_path / "p.pat")
    _run("snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", pat])
    for flags, n in (([], 0), (["-v"], 2)):
        calls.clear()
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            assert vaf_counter.main(["-k21", *flags, "-p", pat, "-o",
                                     str(tmp_path / "a.vaf"), A1, A1]) == 0
        assert len(calls) == n
        assert ("Mbases/sec" in err.getvalue()) == bool(flags)


def _edvaf_inputs(tmp_path):
    """A pattern file of three 21-base k-mers and two gzipped FASTQ
    files, of 50 and 37 reads of 30-150 bases: (paths, bases a
    file)."""
    import gzip

    rng = np.random.default_rng(7)
    pat = str(tmp_path / "p.pat")
    with open(pat, "w") as f:
        for i in range(3):
            ref = "".join(rng.choice(list("ACGT"), 21))
            alt = ref[:10] + "ACGT"[("ACGT".index(ref[10]) + 1) % 4] + \
                ref[11:]
            f.write(f"chr1\t{100 * i}\t{100 * i + 1}\trs{i}\t{ref[10]}\t"
                    f"{alt[10]}\t{ref}\t{alt}\n")
    paths, n_bases = [], []
    for n in (50, 37):
        lens = rng.integers(30, 151, n)
        text = "".join(f"@r{i}\n{''.join(rng.choice(list('ACGTN'), L))}\n+"
                       f"\n{'I' * L}\n" for i, L in enumerate(lens))
        paths.append(str(tmp_path / f"s{n}.fq.gz"))
        with gzip.open(paths[-1], "wt") as f:
            f.write(text)
        n_bases.append(int(lens.sum()))
    return pat, paths, n_bases


def test_ed_vaf_counter_spans(monkeypatch, tmp_path):
    """With the tracer on, one ed-vaf-counter call over two files (16
    rows a batch): `edvaf.patterns`, then one `edvaf.file` a file with
    its bases, those of the native reader (all of them on its path, none
    under KMER_TPU_NO_NATIVE=1) and no staging wait, its `edvaf.drain`
    inside it, then `edvaf.write`; with it off, nothing; the same VAF
    file all three ways."""
    from kmer_tpu_torch.io import native

    monkeypatch.setattr(ed_vaf_counter, "_BATCH_BYTES", 16 << 10)
    pat, paths, n_bases = _edvaf_inputs(tmp_path)
    out = {}
    for on, path in ((True, "native"), (True, "python"), (False, "native")):
        if path == "python":
            monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("KMER_TPU_NO_NATIVE", raising=False)
        trace.clear()
        trace.enable(on)
        vaf = str(tmp_path / f"{on}{path}.vaf")
        _run("ed-vaf-counter", ["-e1", "-p", pat, "-o", vaf, *paths])
        out[on, path] = open(vaf).read()
        rec = trace.spans()
        if not on:
            assert rec == []
            continue
        on_native = path == "native" and native.available()
        assert [s.name for s in sorted(rec, key=lambda s: s.t0)] == [
            "edvaf.patterns", "edvaf.file", "edvaf.drain", "edvaf.file",
            "edvaf.drain", "edvaf.write"]
        files = [s for s in rec if s.name == "edvaf.file"]
        for f, drain, b in zip(
                files, [s for s in rec if s.name == "edvaf.drain"],
                n_bases):
            assert drain.parent == f.id
            assert f.t0 <= drain.t0 <= drain.t1 <= f.t1
            assert f.attrs == {"bases": b, "wait_ns": 0,  # the CPU
                               "native_bases": b if on_native else 0}
    assert len(set(out.values())) == 1
