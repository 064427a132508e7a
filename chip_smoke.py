#!/usr/bin/env python3
"""chip_smoke.py — run the port's kc-c4, yak-count (one file and two),
SNP-fingerprint and ed-vaf-counter paths on one GPU, with ASCII and
packed 2-bit ingest, its host-only tools, the mesh on logical shards
of the card, runs of several processes, the open-addressing table
engines, and the KMER_TPU_DEBUG cross-checks.

Usage: python3 chip_smoke.py [--seed N]

Phases, each printing its own lines:
  1. card     the GPU's name and power limit (nvidia-smi), torch/CUDA
  2. build    the kernels from kmer_tpu_torch/csrc/ (first-use nvcc build)
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card, lane for lane (tolerance 0: integer outputs), at the
              main path's shapes, with both times (CUDA events), its
              bound (bytes at 3.35 TB/s) and, where PyTorch computes the
              same function, that call's time: extract in both forms
              (flat, and row-sliced on a 10 Mbase block of 150 bp reads)
              at k = 1, 15, 21, 31, 32, with its issue-side bound from
              the kernel's SASS; the one-pass segment histogram at 2^27
              and 2^28 lanes (unweighted and weighted, kc's and
              yak-count's bins, an all-equal plane, a ragged n), beside
              bincount(unique_consecutive) as its yardstick, and at 2^28
              lanes with weighted totals past 2^31 and 2^32 (segments
              across blocks, the open final run, the sentinel's; n_bins
              256, 1024 and 2048) == plain == a uint32 model; the merge
              path (merge_partition + merge_path) for its three lane
              types, int64 keys, int32 keys and (int64 key, int64 index)
              lanes, against a sort of the concatenation on edge cases
              and at 2^25 and 2^28 (for (key, index) 2^27) output lanes,
              timed in turns with its plain version and torch.sort;
              both Myers kernels (csrc/myers.cu), their (R, P) counts
              and their sums a pattern, on every case of
              tests/torch_myers_cases.py, at ed-vaf-counter's batch
              (2,048 reads x 2,000 21-base patterns, n_alpha 4) and at
              the 21,000-site panel's (x 42,000), pattern lengths 0, 1,
              21, 32, W = 2, 4, 9 (n_alpha 40) and reads of 0-4,096
              bases, and phase 11's long-pattern batch, each at its
              max_e and past every lane's best (all counts compared);
              the tool's shapes timed in turns with the plain version
              and the one-lane baseline kernel (scripts/myers_baseline.cu,
              built beside the library in phase 2), with the operation
              bound and the
              issue and ALU-pipe bounds from the SASS of each kernel's
              loop
  4. e2e      `kc-c4 -k31` through kmer_tpu_torch.tools on a synthetic
              gzipped FASTQ (24 MiB genome, 150 bp reads, 0.5% errors,
              256 Mbases, made from --seed and cached under
              build/chip_smoke/); its stdout must equal the same engine's
              with the plain kernel versions on the card, every kernel's
              launch count in that run must be > 0, and the engine's
              hist must run no torch.bincount (phases 6, 7 and 8 too)
  5. budget   32 Mbases under a budget small enough to force compactions
              (the weighted segment histogram), kernels vs plain
  6. yak      `yak-count -k31 -b30` through kmer_tpu_torch.tools on the
              256 Mbase file: stdout and the `[M` stderr lines must equal
              the same run with the plain kernel versions in the engine
              and the admission tap; the (key, index) merge-path kernels
              must launch in it
  7. packed   phases 4 and 6 again with packed 2-bit ingest
              (KMER_TPU_PACKED=1): stdout, and yak-count's `[M` lines,
              must equal theirs, every block must take the structural
              step (its mask elided), extract, the int64 merge path and
              seghist (and the (key, index) merge path for yak-count)
              must launch; prints wall, Mbases/s beside phase 4's, the
              bytes staged (the `reader.stage` spans of a second,
              untimed pass with the port's tracer on), and the unpack's
              device time a 10 Mbase block (masked and structural, each
              equal to the ASCII reader's block) beside its byte bound
  8. onepl    kc-c4 -k15 (one-plane keys) on 32 Mbases under the 64 MiB
              budget, kernels vs plain; the int32 merge-path kernels and
              the budget trips' (key, count) merge path must launch in
              it, the int64 ones not
  9. snp      the SNP-fingerprint chain at NGSCheckMate's panel size:
              snp-pattern-gen -k21 on the smoke's 24 MiB genome (24
              chromosomes, gzipped FASTA) with 21,000 seeded SNP sites,
              vaf-counter -k21 -v on three samples (A: 256 Mbases and A2:
              64 Mbases from genotype X, B: 64 Mbases from genotype Y;
              each genotype homozygous alt at its own seeded half of the
              sites), correlation-matrix -t and match-classifier -v -P,
              all through kmer_tpu_torch.tools; every file must equal the
              same chain's with the plain kernel versions, the classifier
              must match A with A2 and neither with B, extract and the
              int64 merge path must launch, seghist and the other merges
              not; prints each tool's wall and peak memory, vaf-counter
              A's -v report and counts_for's time over A's key plane
 10. yak2     two-file `yak-count -k31 -b30 A B` (A: phase 4's 256 Mbase
              file, B: phase 9's 64 Mbase sample of genotype Y): stdout
              and every `[M` line must equal the same run with the plain
              kernel versions in both compactors; extract, the int64
              merge path and the folds' (key, count) merge path must
              launch, no other kernel; prints the wall,
              both passes' IngestStats, the bloom admission's device time
              over pass 1, the shrink join's time and the peak device
              memory (the 128 MiB packed bits array and both compactors)
 11. edvaf    ed-vaf-counter -e1 on sample B (64 Mbases) with the first
              1,000 sites of phase 9's panel (2,000 patterns at k = 21),
              then with the whole panel (~21,000 sites, 42,000
              patterns): wall, Mbases/s, the Myers kernel's device time
              (CUDA events around each call) and its share of the wall,
              peak device memory; `myers` must launch once a batch
              through the sum entry and no other kernel, and the batch
              loop must make no synchronizing call (it runs under
              torch.cuda.set_sync_debug_mode("error")); the whole
              panel's rows for the first 1,000 sites must equal the
              1,000-site run's, and on its first batch the kernel's sums
              the plain version's on the card; on B's first 2,048 reads
              (one batch) the card's VAF file must equal the CPU's, and
              so must it with a panel of LONG_SITES sites at k = 45 and
              97 cut from phase 9's genome (the sites found in those
              reads first), where `myers_multiword` must launch once
 12. fixture  kc-c4 on tests/fixtures at k=15, 21 and 31, yak-count on the
              reads fixture, two-file yak-count on sampleA1 + sampleB
              (-k31 -b19 -K65536, -k15 -b19, -b0), the SNP chain on the
              genome, BED and sample fixtures, and ed-vaf-counter -e0/1/2
              on its patterns over sampleA1: the port on the GPU gives
              the bytes of the port on the CPU; kc-c4 (k = 15, 31) and
              yak-count again with packed ingest (masked blocks: the
              fixtures hold N bases and varied lengths), GPU == CPU ==
              the ASCII path
 13. hosttools  kc-py1, kc-cpp1 and kc-cpp2 on the genome fixture (each
              == kc-c1 -k31 on the card), vcf-vaf-counter on sampleA's
              VCF, .vcf.gz and BCF (one VAF file), bam-vaf-counter on an
              unindexed copy of the BAM fixture (the native scan must
              run, and equal the Python reader's VAF) and with its .bai,
              and the native rANS 4x8 decoder against the Python one on
              an encoded stream; no kernel may launch
 14. mesh     the single-process mesh on 4 logical shards of the card
              (through dist.sharded.default_devices, KMER_TPU_FORCE_MESH=1):
              kc-c4 -k31 on the 256 Mbase file (stdout == phase 4's ==
              the mesh with the plain kernel versions; extract, the int64
              merge path and seghist launch; wall and Mbases/s beside
              phase 4's, peak memory, and the routing + exchange of one
              step timed beside its byte bound), kc-c4 -k15 on 32 Mbases
              under the 64 MiB budget split over the shards (== phase 8
              == plain; the int32 merge path launches, a shard's budget
              trips), two-file yak-count -k31 -b30 A B (stdout == phase
              10's; stdout and `[M` lines == plain; the (key, index)
              merge path launches; wall, peak memory), vaf-counter -k21 on
              sample A (VAF file == phase 9's), a 1-shard mesh through the
              CLI gate on the default device list (kc-c4 -k31 on the reads
              fixture == phase 12's bytes), and a checkpoint saved on the
              card mesh after sampleA1 and resumed on a 4-shard CPU mesh
              for sampleB (hist == an uninterrupted run)
 15. multiproc  runs of 2 processes x 2 logical shards of the card (4
              global shards, gloo, each process started with a free
              port, its rank and the world size, killed if it hangs):
              kc-c4 -k31 over phase 4's file and a second 256 Mbase file
              of the same recipe (one file a process) == one engine over
              both, and == with the plain kernel versions; two-file
              yak-count -k31 -b30 A B == phase 10's stdout; vaf-counter A
              == phase 9's VAF file (process 0 writes it, process 1
              none); KMER_TPU_SINGLE_READER=1 two-file yak-count ==
              phase 10's stdout and phase 14's `[M` lines; a checkpoint
              saved by a generation that counted the first file and
              resumed by a new one that counts the second == one engine
              over both.  Extract, the int64 merge path and seghist (and
              the (key, index) merge path for yak-count) must launch in
              each worker; it prints each run's wall, Mbases/s, each
              process's peak device memory and the exchange's time a
              step (D2H + gloo + H2D, synchronized) beside its PCIe byte
              bound.  On a machine of several cards, one process a card
              under NCCL: kc-c4 and two-file yak-count again
 16. table    the open-addressing table engines (KMER_TPU_TABLE_YAK=1):
              the slot-resolve kernel (csrc/table.cu) against its plain
              version on the first three 10 Mbase blocks of A (a fresh
              table; a table near GROW_LOAD holding tombstones, and
              insert_gated's planes there; lookups with create_new off),
              with rounds, probe-lanes, both times (CUDA events), the
              byte bound (random 32-byte sectors), one host
              synchronization a call and a round's floor in the
              one-block tail and on the grid; the kernel's cooperative
              grid and its registers (`-Xptxas -v`); the plain-torch
              count delta, first lane and hist beside their bounds;
              `KMER_TPU_TABLE_YAK=1 yak-count -k31 -b30 A B` through
              the tool (YakEngine): stdout and `[M` lines == phase 10's,
              extract and resolve launch, resolve once a call, and no
              merge or seghist kernel; wall, Mbases/s,
              peak memory, final capacity, rebuilds, rounds; a
              checkpoint saved after pass 1 and resumed on the card ==
              phase 10's stdout; MeshYakEngine on phase 14's 4 shards
              (== phase 10's stdout, phase 14's `[M` lines) and in phase
              15's two processes (== phase 10's stdout, phase 15's `[M`
              lines; its wall beside phase 15's sort engine's)
 17. debug    KMER_TPU_DEBUG=1, the JAX package's runtime cross-check of
              hist and counts_for (scripts/tpu_smoke.py on the TPU):
              its CASES on the reads fixture (kc-c1 -k21, kc-c2 -k31
              -p10, kc-c4 -k31 and -k15, yak-count -k21 -b14), the
              fixture snp-pattern-gen -> vaf-counter chain and kc-c4 -k31
              on MESH_SHARDS logical shards, with 2^15-lane stream chunks
              so the ladders merge: each output == its run with the
              switch unset (which makes no check), each hist (each
              counts_for) checked once a compactor, on a plane that the
              merge path (int32 at -k15) built and seghist read; kc-c4
              -k31 on phase 4's file (stdout == phase 4's; wall beside
              phase 4's, the check's device time (CUDA events) and the
              memory it allocates, the run's peak beside phase 4's) and
              vaf-counter on phase 9's sample A2 (VAF file == phase 9's);
              the CUDA wrappers seghist.segment_hist_sorted and
              merge.merge_runs made to corrupt one lane: kc-c4 -k31 on
              the fixture exits 0 with the switch unset and raises the
              debug AssertionError under it; compactors on the card and
              on the CPU holding counted runs whose key totals pass 2^31
              and 2^32: the same hist under the switch, no check raising

Each path's launch counts are set to 0 just before it runs and read just
after; the kernels line takes the counts of extract, seghist and the
int64 merge path from phase 4, the int32 merge path's from phase 8, the
(key, index) merge path's from phase 6, resolve's from phase 16's
tool run, myers's from phase 11's whole-panel run on B and
myers_multiword's from its long-pattern run (phases 7, 10, 14, 15 and
17 print their own).  After every phase neither jax nor any module of
the JAX package (kmer_tpu) may be loaded.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero without
them; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
import json
import os
import subprocess
import sys
import time
import traceback
import zlib

from h100bench import myers_work as bench_myers

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "build", "chip_smoke")
READ_LEN = 150
GENOME_BASES = 24 << 20
K = 31
MBASES = 256  # the e2e run's size: the JAX bench's headline file
ERR_FREE = 0  # tolerance of every comparison: outputs are integers
# the kernels of the kc-c4 -k31 path (phase 4); yak adds the (key, index)
# merge (phase 6), k <= 15 swaps the merge for the int32 one (phase 8)
KC_PATH_KERNELS = ("extract", "seghist", "merge_partition", "merge_path")
YAK_TAP_KERNELS = ("merge_partition3", "merge_path3")
ONE_PLANE_KERNELS = ("merge_partition1", "merge_path1")


def no_jax_package(phase):
    """The port imports neither jax nor anything of the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("kmer_tpu", "jax"))
    need(not bad, f"[{phase}] the port imported {bad[:10]}")


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def stats_line(st) -> str:
    """A count loop's IngestStats in one line."""
    return (f"loop {st.loop_s:.2f}s (reader {st.reader_s:.2f}s, main wait "
            f"{st.wait_s:.2f}s, dispatch {st.dispatch_s:.2f}s)")


def staged(fn):
    """Call fn() with the port's tracer (kmer_tpu_torch/utils/trace.py)
    on, in a pass of its own that nothing times: the bytes and seconds
    of its `reader.stage` spans."""
    from kmer_tpu_torch.utils import trace

    trace.clear()
    trace.enable(True)
    try:
        fn()
    finally:
        trace.enable(False)
    rec = [s for s in trace.spans() if s.name == "reader.stage"]
    trace.clear()
    return {"bytes": sum(s.attrs["bytes"] for s in rec),
            "s": sum(s.t1 - s.t0 for s in rec)}


# -- timing -------------------------------------------------------------

def time_ms(fn, setup=lambda: None, reps=5):
    """Mean device time of fn(setup()) over reps (CUDA events), after one
    warm-up call; setup runs outside the timed region."""
    import torch

    fn(setup())
    total = 0.0
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def time_run_ms(fn, reps=5):
    """Mean device time of fn() over a run of reps calls between two CUDA
    events, after one warm-up call: the calls queue up, so the device
    does not wait for the host between them (a kernel of ~0.1 ms timed
    alone also counts the host's gap before its launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(a, b):
    """Largest |a - b| over integer lanes.  Exact when it is 0: unequal
    lanes count at least 1 even where float64 cannot tell them apart
    (int64 keys above 2^53)."""
    import torch

    need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0.0
    return max(1.0, float((a.double() - b.double()).abs().max()))


# -- synthetic reads ----------------------------------------------------

def genome_codes(seed: int):
    """The smoke's random 24 MiB genome (2-bit codes), made from seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, GENOME_BASES, dtype=np.uint8), rng


def reads_file(mbases: int, seed: int) -> str:
    """Gzipped FASTQ of mbases Mbases of 150 bp reads sampled with 0.5%
    substitution errors from a random 24 MiB genome (cached)."""
    path = os.path.join(DATA_DIR, f"reads_{mbases}M_s{seed}.fq.gz")
    if not os.path.exists(path):
        genome, rng = genome_codes(seed)
        write_reads(path, genome, mbases, rng)
    return path


def write_reads(path: str, genome, mbases: int, rng) -> None:
    """Write mbases Mbases of 150 bp reads from genome (2-bit codes),
    each base substituted with probability 0.5%, as gzipped FASTQ."""
    import numpy as np

    os.makedirs(DATA_DIR, exist_ok=True)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n_reads = mbases * 1_000_000 // READ_LEN
    name_w = 10  # "@r" + 9 digits + "\n"
    rec = name_w + 2 + READ_LEN + 3 + READ_LEN + 1
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        comp = zlib.compressobj(1, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        for off in range(0, n_reads, 200_000):
            n = min(200_000, n_reads - off)
            starts = rng.integers(0, genome.shape[0] - READ_LEN, n)
            codes = genome[starts[:, None] + np.arange(READ_LEN)]
            err = rng.random(codes.shape) < 0.005
            codes = np.where(err, rng.integers(0, 4, codes.shape), codes)
            out = np.empty((n, rec), np.uint8)
            out[:, 0:2] = np.frombuffer(b"@r", np.uint8)
            ids = off + np.arange(n)
            for d in range(name_w - 1):
                out[:, 2 + d] = 48 + (ids // 10 ** (name_w - 2 - d)) % 10
            c = 2 + name_w - 1
            out[:, c] = 10
            out[:, c + 1:c + 1 + READ_LEN] = acgt[codes]
            c += 1 + READ_LEN
            out[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, c + 3:c + 3 + READ_LEN] = ord("I")
            out[:, -1] = 10
            f.write(comp.compress(out.tobytes()))
        f.write(comp.flush())
    os.replace(tmp, path)


# -- phases ---------------------------------------------------------------

def phase_card():
    import torch

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    card = r.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


MYERS_BASELINE_BUILD = None  # phase 3's baseline, its build started in phase 2


def phase_build():
    global MYERS_BASELINE_BUILD
    from kmer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    # the one-lane Myers kernel builds beside the library, for phase 3
    MYERS_BASELINE_BUILD = start_myers_baseline()
    _build.library()
    took = time.perf_counter() - t0
    how = ("built" if _build.build_seconds is not None else "loaded")
    say("build", f"{how} {os.path.relpath(_build._library_path(), HERE)} "
        f"from {len(_build.sources())} sources in {took:.2f} s")
    # the native FASTQ reader also builds at first use (g++); build it
    # here so that the e2e phase times reading, not compiling
    from kmer_tpu_torch.pipeline.counter import native_reader

    t0 = time.perf_counter()
    need(native_reader(), "the native reader does not build: e2e would "
         "time the pure-Python reader")
    say("build", f"native reader ready in {time.perf_counter() - t0:.2f} s")


HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, the published peak at 700 W


def kernel_row(err, ms, plain_ms, nbytes, library_ms=None):
    """One kernel's numbers for the kernels line: its bound is the bytes
    it must move (each input read once, each output written once) at
    the card's memory rate.  The operation bound is not taken: NVIDIA's
    published peak rates give no integer-ALU rate, and these kernels
    compare and shift integers."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms}


def timing_text(row, library="torch.sort"):
    lib = row["library_ms"]
    return (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.4f} ms, "
            + (f"{library} {lib:.3f} ms" if lib is not None
               else "no one PyTorch call computes it"))


def partition_bytes(na, nb, tile, key_bytes):
    """Bytes merge_partition must move for these run lengths: per split,
    two keys for each step of its binary search (an index only on a key
    tie: not counted), and the split out."""
    import numpy as np

    n = na + nb
    d = np.minimum(np.arange(0, -(-n // tile) + 1, dtype=np.int64) * tile, n)
    width = np.minimum(d, na) - np.maximum(0, d - nb)
    steps = np.ceil(np.log2(width + 1.0))
    return int(2 * key_bytes * steps.sum() + 8 * d.shape[0])


def key_idx_sort(key, idx):
    """(key, index) order of arbitrary lanes: by index, then stably by
    key."""
    import torch

    idx, o = torch.sort(idx, stable=True)
    key, o = torch.sort(key[o], stable=True)
    return key, idx[o]


def merge_path_rows(rows, sfx, runs, cases, sizes):
    """One lane type's merge path (sfx "": int64 keys, "1": int32 keys,
    "3": (int64 key, int64 index) lanes): merge_partition and merge_path
    against a sort of the concatenation lane for lane (torch.sort, or for
    (key, index) lanes a sort by index then stably by key), on edge cases
    and at 2^lg output lanes for lg in sizes (two 2^(lg-1)-lane runs, 15%
    sentinel lanes), and the ways to compute the whole merge timed in
    turns on the same runs: the kernels, the plain version and torch.sort
    (library_ms; for (key, index) lanes the two stable torch.sort calls
    of key_idx_sort, as no one PyTorch call sorts them), each as a run of
    calls between two events.  A run is a tuple of planes.  The kernels
    line takes the 2^25 numbers (the ladder's first merge)."""
    import torch

    from kmer_tpu_torch.kernels import merge

    if sfx == "3":
        tile = merge.tile_lanes3()
        partition, path, whole = (merge.merge_partition3, merge.merge_path3,
                                  merge.merge_runs3)
        plain, partition_plain = (merge.merge_runs3_plain,
                                  merge.merge_partition3_plain)
        sort = key_idx_sort
    else:
        tile = merge.tile_lanes(torch.int32 if sfx else torch.int64)
        partition, path, whole = (merge.merge_partition, merge.merge_path,
                                  merge.merge_runs)
        plain, partition_plain = (merge.merge_runs_plain,
                                  merge.merge_partition_plain)

        def sort(x):
            return torch.sort(x).values

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def cat(a, b):
        return tuple(torch.cat([x, y]) for x, y in zip(a, b))

    def err(got, want):
        return max(max_abs_err(x, y) for x, y in zip(tup(got), want))

    name = f"merge_path{sfx}"
    cases = cases(tile)
    for label, (a, b) in cases.items():
        want = tup(sort(*cat(a, b)))
        e = max(err(whole(*a, *b), want), err(plain(*a, *b), want))
        need(e == ERR_FREE, f"{name} {label}: != the sort (max err {e})")
        n = a[0].shape[0] + b[0].shape[0]
        if n:
            e = max_abs_err(partition(*a, *b), partition_plain(*a, *b, tile))
            need(e == ERR_FREE, f"merge_partition{sfx} {label}: != plain")
    say("kernels", f"{name} (tile {tile}): equal to the sort on the edge "
        f"cases ({', '.join(cases)})")
    del cases

    for lg in sizes:
        n = 1 << lg
        a, b = runs(n // 2, n // 2)
        lane_bytes = sum(p.element_size() for p in a)
        want = tup(sort(*cat(a, b)))
        splits = partition(*a, *b)
        e_part = max_abs_err(splits, partition_plain(*a, *b, tile))
        e = max(err(path(*a, *b, splits), want), err(plain(*a, *b), want))
        need(e == e_part == ERR_FREE,
             f"{name} 2^{lg}: kernel or plain err {e}, partition err "
             f"{e_part}")
        del want
        ways = {
            "merge_path": lambda: path(*a, *b, splits),
            "merge_partition": lambda: partition(*a, *b),
            "merge_runs": lambda: whole(*a, *b),
            "plain": lambda: plain(*a, *b),
            "partition_plain": lambda: partition_plain(*a, *b, tile),
        }
        # (key, index) lanes: a sort by index, then a stable one by key
        ways["torch.sort"] = lambda: sort(*cat(a, b))
        times = {w: [] for w in ways}
        for w in [*ways, *reversed(ways)]:  # in turns, both ways round
            times[w].append(time_run_ms(ways[w]))
        t = {w: sum(v) / len(v) for w, v in times.items()}
        nbytes = 2 * lane_bytes * n + 8 * splits.shape[0]
        lib = t["torch.sort"]
        lib_name = ("two stable torch.sort" if sfx == "3"
                    else "torch.sort")
        say("kernels", f"{name} 2^{lg} lanes (two 2^{lg - 1}-lane runs): "
            f"equal to the sort; merge_path{sfx} {t['merge_path']:.3f} ms + "
            f"merge_partition{sfx} {t['merge_partition']:.3f} ms (together "
            f"{t['merge_runs']:.3f} ms), bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms; plain "
            f"{t['plain']:.3f} ms; {lib_name} {lib:.3f} ms")
        if lg == 25:
            rows[name] = kernel_row(e, t["merge_path"], t["plain"], nbytes,
                                    lib)
            rows[f"merge_partition{sfx}"] = kernel_row(
                e_part, t["merge_partition"], t["partition_plain"],
                partition_bytes(n // 2, n // 2, tile, a[0].element_size()))
        del a, b, splits
        torch.cuda.empty_cache()


def merge_path_lane_types(rows, g, dev):
    """merge_path_rows for the three lane types, at the shapes of their
    ladders: int64 (kc-c4 -k31: 2^25 lanes first, 2^28 at the fold), int32
    (kc-c4 -k15, the same ladder) and (key, index) (yak-count's tap: 2^25
    first, 2^27 at a budget trip)."""
    import torch

    from kmer_tpu_torch.kernels.keys import SENT, SENT32

    idx_sent = (1 << 63) - 1  # the tap's pad index (pipeline/yak_admit.py)

    def sprinkle(v, sent):
        v[torch.rand(v.shape[0], generator=g, device=dev) < 0.15] = sent
        return v

    def runs64(na, nb, pool=None):
        v = torch.randint(-(1 << 62), 1 << 62, (pool or na + nb,),
                          generator=g, device=dev)
        if pool:
            v = v[torch.randint(0, pool, (na + nb,), generator=g,
                                device=dev)]
        v = sprinkle(v, SENT)
        return (torch.sort(v[:na]).values,), (torch.sort(v[na:]).values,)

    def runs32(na, nb, pool=None):
        v = sprinkle(torch.randint(0, pool or 1 << 30, (na + nb,),
                                   generator=g, device=dev,
                                   dtype=torch.int32), SENT32)
        return (torch.sort(v[:na]).values,), (torch.sort(v[na:]).values,)

    def runs3(na, nb, pool=None):
        """The ladder's shape: keys repeat (a pool of a quarter of the
        lanes), the index rises over a then b, so a stable key sort of
        each is its (key, index) order."""
        n = na + nb
        pool = pool or max(2, n // 4)
        key = sprinkle(torch.randint(-(1 << 62), 1 << 62, (pool,),
                                     generator=g, device=dev)[
            torch.randint(0, pool, (n,), generator=g, device=dev)], SENT)
        idx = torch.arange(n, device=dev) + (1 << 31)

        def run(lo, hi):
            k, o = torch.sort(key[lo:hi], stable=True)
            return k, idx[lo:hi][o]

        return run(0, na), run(na, n)

    def full(m, x, dtype=torch.int64):
        return torch.full((m,), x, dtype=dtype, device=dev)

    sizes = ((0, 0), (0, 5), (5, 0), (4095, 1), (4097, 12345),
             (777_777, 12_345))

    def cases1(runs, dtype, sent):
        def cases(tile):
            out = {f"{na}+{nb}": runs(na, nb) for na, nb in sizes}
            out["dups"] = runs(100_003, 99_999, pool=50)
            out["all_equal"] = ((full(3 * tile + 5, 7, dtype),),
                                (full(3 * tile, 7, dtype),))
            out["all_sentinel"] = ((full(tile + 1, sent, dtype),),
                                   (full(2 * tile, sent, dtype),))
            return out
        return cases

    def cases3(tile):
        out = {f"{na}+{nb}": runs3(na, nb) for na, nb in sizes}
        out["dups"] = runs3(100_003, 99_999, pool=50)
        # one key on every lane (k = 32), the indices interleaved between
        # the runs: the index decides every compare, across many tiles
        n = 6 * tile + 5
        i, key = torch.arange(n, device=dev), full(n, 7)
        out["one_key_interleaved"] = (
            (key[::2].contiguous(), i[::2].contiguous()),
            (key[1::2].contiguous(), i[1::2].contiguous()))
        # invalid lanes (SENT, real index) among (SENT, IDX_SENT) pads
        idx = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, i,
                          idx_sent)
        h = 2 * tile + 1
        out["sentinels_and_pads"] = (
            (full(h, SENT), torch.sort(idx[:h]).values),
            (full(n - h, SENT), torch.sort(idx[h:]).values))
        return out

    merge_path_rows(rows, "", runs64, cases1(runs64, torch.int64, SENT),
                    (25, 28))
    merge_path_rows(rows, "1", runs32, cases1(runs32, torch.int32, SENT32),
                    (25, 28))
    merge_path_rows(rows, "3", runs3, cases3, (25, 27))


def reads_block(rng, dev):
    """One block as the engine's reader packs it from the e2e file: 150
    bp reads of ACGT with 0.5% errors and a rare N, one NUL after each,
    66,666 reads (10 Mbases) in a buffer of the engine's capacity
    (10,312,500 bytes, zeros after the last read)."""
    import numpy as np
    import torch

    capacity = 10_000_000 + 10_000_000 // 32
    n_reads = 10_000_000 // READ_LEN
    rows = np.zeros((n_reads, READ_LEN + 1), np.uint8)
    rows[:, :READ_LEN] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_reads, READ_LEN))]
    rows[:, :READ_LEN][rng.random((n_reads, READ_LEN)) < 1e-4] = ord("N")
    buf = np.zeros(capacity, np.uint8)
    buf[:rows.size] = rows.reshape(-1)
    return torch.from_numpy(buf).to(dev)


def sass_lines(symbol, library=None):
    """The SASS instructions (address, text) of the one kernel whose
    mangled name holds `symbol`, from cuobjdump of the built library (or
    of `library`; None when the toolkit has no cuobjdump)."""
    import re
    import shutil

    from kmer_tpu_torch.kernels import _build

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = next((c for c in (os.path.join(home, "bin", "cuobjdump"),
                             shutil.which("cuobjdump"))
                 if c and os.path.exists(c)), None)
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", library or _build._library_path()],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        return None
    lines, inside = [], False
    for line in r.stdout.splitlines():
        if "Function :" in line:
            inside = symbol in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([A-Z@].*?)\s*;", line)
        if inside and m and " NOP" not in f" {m.group(2)}":
            lines.append((int(m.group(1), 16), m.group(2)))
    return lines or None


def sass_per_thread(symbol):
    """Static SASS instruction count of a kernel (sass_lines).  The
    extract kernel has no loop left, so this counts each branch once."""
    lines = sass_lines(symbol)
    return len(lines) if lines else None


# the opcodes that issue to an SM sub-partition's ALU pipe (16 lanes a
# clock): logic, 3-input adds, shifts, compares, selects, min/max, byte
# permutes, LEA and MOV; IMAD and its aliases (IMAD.SHL, IMAD.MOV,
# IMAD.IADD) issue to the FMA pipe, loads and stores to the memory pipe
ALU_OPCODES = {"LOP3", "LOP", "PLOP3", "IADD3", "IADD", "SHF", "ISETP",
               "SEL", "FSEL", "IMNMX", "VIMNMX", "PRMT", "LEA", "MOV",
               "BMSK", "SGXT", "IABS", "P2R", "R2P", "FLO", "POPC", "BREV"}


def opcode(text):
    """The opcode of one SASS instruction, its predicate guard dropped."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_per_step(symbol, library=None):
    """(SASS instructions of a kernel's loop over text positions, steps in
    it, ALU-pipe instructions of them): of the bodies of the innermost
    backward branches, the one with the most read codes (a one-byte
    global load `LDG...U8` is one step, a 16-byte `LDG...128` sixteen),
    the longest on a tie.  None where cuobjdump is missing or prints no
    such loop."""
    import re

    lines = sass_lines(symbol, library)
    loops = []
    for addr, text in lines or ():
        m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        if any(lo < a and b < hi for a, b in loops):
            continue  # an outer loop (over reads, or a chunk's groups)
        body = [t for a, t in lines if lo <= a <= hi]
        steps = sum(16 if ".128" in t else 1 for t in body
                    if "LDG" in t and (".U8" in t or ".128" in t))
        if steps and (best is None or (steps, len(body)) > best[1::-1]):
            best = (len(body), steps,
                    sum(opcode(t) in ALU_OPCODES for t in body))
    return best


def sm_clock_mhz():
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.split()[0]) if r.returncode == 0 else None


def extract_rows(rows, rng, dev):
    """Both extract forms against their plain versions on one reads block
    at k = 1, 15, 21, 31, 32 and on a dirty flat block; times at k = 31.
    The kernels line takes the rows form, the main path's on 150 bp
    reads.  Bound: one byte read a position, 8 bytes a key written, and
    the valid count; beside it the issue side: static SASS instructions
    a thread / the positions a thread handles, over 4 warp-issues a clock
    on each SM at the card's max SM clock."""
    import numpy as np
    import torch

    from kmer_tpu_torch.kernels import _build, extract

    block = reads_block(rng, dev)
    rb = READ_LEN + 1
    alphabet = np.frombuffer(b"ACGTacgtN\x00x", np.uint8)
    dirty = torch.from_numpy(rng.choice(
        alphabet, size=10_000_000 + 7, p=[0.124] * 8 + [0.008 / 3] * 3)).to(dev)
    err = 0.0
    for k in (1, 15, 21, 31, 32):
        for label, x, fn, plain, args in (
                ("flat", dirty, extract.extract_keys,
                 extract.extract_keys_plain, ()),
                ("flat", block, extract.extract_keys,
                 extract.extract_keys_plain, ()),
                ("rows", block, extract.extract_keys_rows,
                 extract.extract_keys_rows_plain, (rb,))):
            got, nv = fn(x, k, *args)
            want, nw = plain(x, k, *args)
            e = max_abs_err(got, want)
            need(e == ERR_FREE and int(nv) == int(nw),
                 f"extract {label} k={k}: kernel != plain (max err {e}, "
                 f"{int(nv)} vs {int(nw)} valid)")
            err = max(err, e)
        say("kernels", f"extract k={k}: flat (dirty 10 Mbase block, reads "
            f"block) and rows forms equal to plain, {int(nv)} valid lanes")
    n = block.numel()
    kept = n // rb * (rb - K)
    t = {}
    for name, fn in (
            ("rows", lambda _: extract.extract_keys_rows(block, K, rb)),
            ("flat", lambda _: extract.extract_keys(block, K)),
            ("rows_plain",
             lambda _: extract.extract_keys_rows_plain(block, K, rb)),
            ("flat_plain", lambda _: extract.extract_keys_plain(block, K))):
        t[name] = time_ms(fn, reps=20 if "plain" not in name else 3)
    rows["extract"] = kernel_row(err, t["rows"], t["rows_plain"],
                                 n + 8 * kept + 8)
    flat_bound = (9 * n + 8) / HBM_BYTES_PER_S * 1e3
    say("kernels", f"extract rows k={K} (10 Mbase reads block, {n} "
        f"positions, {kept} keys): {timing_text(rows['extract'])}; flat "
        f"form {t['flat']:.4f} ms (bound {flat_bound:.4f} ms), plain "
        f"{t['flat_plain']:.3f} ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_mhz()
    per_thread = _build.library().ktt_extract_per_thread()
    for label, sym in (("rows", "extract_kernelILb1E"),
                       ("flat", "extract_kernelILb0E")):
        sass = sass_per_thread(sym)
        if sass is None or mhz is None:
            say("kernels", f"extract {label}: issue bound not measured (no "
                "cuobjdump or SM clock)")
            continue
        per_lane = sass / per_thread
        issue_ms = n * per_lane / 32 / (sms * 4 * mhz * 1e6) * 1e3
        say("kernels", f"extract {label}: {sass} SASS instructions a thread "
            f"(static), {per_thread} positions a thread = {per_lane:.1f} a "
            f"position; issue bound at {sms} SMs "
            f"x 4 warp-issues x {mhz:.0f} MHz: {issue_ms:.4f} ms")
    del block, dirty


# weighted segment totals at the edges of the uint32 count width, and
# just below 2^31; seghist reads a total mod 2^32 as uint32, as the JAX
# package's XLA histogram does (_hist_xla_core)
U32_EDGES = (1 << 31, 0x90000000, (1 << 32) - 1, 1 << 32, (1 << 32) + 3,
             (1 << 31) - 1)
U32_CFGS = ((256, None, 1), (1024, 1023, 2), (2048, None, 1))


def u32_bin(total, cfg):
    """The bin of a weighted total as the numpy uint32 model takes it
    (the total mod 2^32, min_keep, max_count, n_bins - 1), or None."""
    n_bins, max_count, min_keep = cfg
    t = total % (1 << 32)
    if t < min_keep:
        return None
    return min(t, n_bins - 1 if max_count is None else max_count, n_bins - 1)


def seghist_u32_edges(keys, g, label):
    """The segment histogram where weighted totals pass 2^31 and 2^32, on
    a sorted plane of the main path's size: 24 spans of seeded uint32
    weights whose totals cycle through U32_EDGES (8 as the plane's
    segments lie, 8 made 2^16 lanes long, 8 made 2^20 lanes long, which
    cross blocks of the persistent grid), and the plane's last segment
    (the open final run, or the sentinel's, which must never count).
    For kc's, yak-count's and a global-atomic (2048) bins_cfg: kernel ==
    plain, and == the plain histogram of the same plane under small
    weights with those segments moved to their numpy uint32 bins; the
    kernel's time on the plane (kc's bins_cfg)."""
    import torch

    from kmer_tpu_torch.kernels import seghist
    from kmer_tpu_torch.kernels.keys import SENT

    dev = keys.device
    keys = keys.clone()
    n = keys.shape[0]
    w = torch.randint(1, 11, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    n_real = int(torch.searchsorted(keys, keys.new_tensor([SENT])))
    part = n_real // 25
    spans = []  # (first lane, end lane, total)
    for i in range(24):
        a = part * i + int(torch.randint(0, part // 2, (1,), generator=g,
                                         device=dev))
        if i % 3:
            keys[a:a + (1 << (16 if i % 3 == 1 else 20))] = keys[a].item()
        v = keys[a:a + 1]
        lo, hi = (int(torch.searchsorted(keys, v, right=r))
                  for r in (False, True))
        spans.append((lo, hi, U32_EDGES[i % len(U32_EDGES)]))
    last = keys[-1:]
    spans.append((int(torch.searchsorted(keys, last)), n, 0x90000000))
    sent_tail = int(last) == SENT
    base = {cfg: seghist.segment_hist_sorted_plain(keys, w, cfg)
            for cfg in U32_CFGS}
    old = [int(w[lo:hi].sum()) for lo, hi, _ in spans]
    for lo, hi, total in spans:
        w[lo:hi] = torch.randint(-(1 << 31), 1 << 31, (hi - lo,),
                                 generator=g, device=dev, dtype=torch.int32)
        rest = (total - int(w[lo:hi - 1].sum())) % (1 << 32)
        w[hi - 1] = rest - (1 << 32) if rest >= 1 << 31 else rest
    counted = [j for j in range(len(spans))
               if not (j == len(spans) - 1 and sent_tail)]
    wide = sum(1 << 31 <= spans[j][2] % (1 << 32) for j in counted)
    for cfg in U32_CFGS:
        hist, nd = seghist.segment_hist_sorted(keys, w, cfg)
        plain, pnd = seghist.segment_hist_sorted_plain(keys, w, cfg)
        e = max(max_abs_err(hist, plain), max_abs_err(nd, pnd))
        need(e == ERR_FREE, f"seghist u32 edges {label} {cfg}: kernel != "
             f"plain (max err {e})")
        want, want_nd = base[cfg][0].clone(), int(base[cfg][1])
        for j in counted:  # the sentinel's segment never counts
            for t, sign in ((old[j], -1), (spans[j][2], 1)):
                b = u32_bin(t, cfg)
                if b is not None:
                    want[b] += sign
                    want_nd += sign
        e = max(max_abs_err(hist, want), abs(int(nd) - want_nd))
        need(e == ERR_FREE, f"seghist u32 edges {label} {cfg}: != the "
             f"numpy uint32 model on the {len(spans)} segments (max err {e})")
    ms = time_ms(lambda _: seghist.segment_hist_sorted(keys, w, U32_CFGS[0]),
                 reps=10)
    spans_text = ", ".join(f"{hi - lo}" for lo, hi, _ in spans[:3])
    say("kernels", f"seghist u32 edges {label} (n={n}, {len(spans)} "
        f"segments: lanes {spans_text}, ..., {spans[-1][1] - spans[-1][0]}; "
        f"final run {'the sentinel' if sent_tail else 'open'}): kernel == "
        f"plain == the uint32 model for bins_cfg {list(U32_CFGS)}, {wide} "
        f"totals in [2^31, 2^32) in the last bin; {ms:.4f} ms (CUDA events, "
        "10 calls)")


def seghist_rows(rows, g, dev):
    """The one-pass segment histogram against its plain version at 2^27
    and 2^28 sorted lanes (keys from 2^25 values, a 20% sentinel tail),
    unweighted and weighted, with kc's and yak-count's bins_cfg, then an
    all-equal plane and a ragged n; its time beside its plain version
    and beside three PyTorch calls that compute the same histogram
    (bincount of the clamped unique_consecutive counts; unweighted).
    The kernels line takes 2^28 lanes, unweighted, kc's config: the
    shape of the kc-c4 -k31 fold."""
    import torch

    from kmer_tpu_torch.kernels import seghist
    from kmer_tpu_torch.kernels.keys import SENT

    def check(keys, w, cfg, label):
        hist, nd = seghist.segment_hist_sorted(keys, w, cfg)
        want, wnd = seghist.segment_hist_sorted_plain(keys, w, cfg)
        e = max(max_abs_err(hist, want), max_abs_err(nd, wnd))
        need(e == ERR_FREE, f"seghist {label} {cfg}: kernel != plain "
             f"(max err {e})")
        say("kernels", f"seghist {label} {cfg}: equal, {int(nd)} segments")
        return e

    err = 0.0
    cfgs = ((256, None, 1), (1024, 1023, 2))
    ragged = (1 << 24) + 12345
    for label, keys in (("all-equal", torch.full((ragged,), 12345,
                                                 dtype=torch.int64,
                                                 device=dev)),
                        ("ragged", torch.sort(torch.randint(
                            0, 1 << 22, (ragged,), generator=g,
                            device=dev)).values)):
        for cfg in cfgs:
            err = max(err, check(keys, None, cfg, f"{label} n={ragged}"))
    del keys
    for lg in (27, 28):
        n = 1 << lg
        keys = torch.sort(torch.randint(0, 1 << 25, (n,), generator=g,
                                        device=dev)).values
        keys[-(n // 5):] = SENT
        w = torch.randint(1, 11, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        for weights in (None, w):
            for cfg in cfgs:
                err = max(err, check(keys, weights, cfg,
                                     f"2^{lg} weighted={weights is not None}"))
        cfg = cfgs[0]
        real = keys[: n - n // 5]  # the library calls cannot skip SENT

        def library(_):
            c = torch.unique_consecutive(real, return_counts=True)[1]
            return torch.bincount(c.clamp(max=cfg[0] - 1), minlength=cfg[0])

        lib_hist = library(None)
        lib_hist[0] = 0
        need(torch.equal(lib_hist,
                         seghist.segment_hist_sorted(keys, None, cfg)[0]),
             f"seghist 2^{lg}: != bincount(unique_consecutive)")
        ms = time_ms(lambda _: seghist.segment_hist_sorted(keys, None, cfg),
                     reps=10)
        wms = time_ms(lambda _: seghist.segment_hist_sorted(keys, w, cfg),
                      reps=10)
        plain_ms = time_ms(
            lambda _: seghist.segment_hist_sorted_plain(keys, None, cfg),
            reps=2)
        library_ms = time_ms(library, reps=3)
        row = kernel_row(err, ms, plain_ms, 8 * n + 8 * (cfg[0] + 1),
                         library_ms)
        say("kernels", f"seghist 2^{lg} lanes unweighted {cfg}: "
            f"{timing_text(row, 'bincount(unique_consecutive) (3 calls)')}; "
            f"weighted {wms:.3f} ms (bound "
            f"{(12 * n + 8 * (cfg[0] + 1)) / HBM_BYTES_PER_S * 1e3:.3f} ms)"
            + ("; PR 4's kernel: 1.1082 ms unweighted" if lg == 28 else ""))
        if lg == 28:
            rows["seghist"] = row
            for name, plane in (("sentinel tail", keys), ("open final run",
                                                          real)):
                seghist_u32_edges(plane, g, f"2^{lg} {name}")
                torch.cuda.empty_cache()
        del keys, w, real
        torch.cuda.empty_cache()


# The 32-bit integer operations of one Myers lane-step, and of each
# further word a pattern spans, come from h100bench/myers_work.py, the
# rates' lanes an SM from h100bench/alu_peaks.json: one home for the
# bound that myers_roofline reads too.
EDVAF_READS = 2048  # one batch of 150 bp reads (the 1024-base bucket)
LONG_SITES = 128  # the long-pattern panel of phase 11
LONG_K = (45, 97)  # its k-mer lengths: 2 and 4 words
MYERS_BASELINE = os.path.join(HERE, "scripts", "myers_baseline.cu")


def myers_work(pat_len, lens, width, n_words, n_alpha):
    """(lane-steps, operations, ALU-only operations, bytes) a Myers scan
    needs on these inputs: each lane steps its read's length (up to the
    width), and a pattern of m bases spans ceil(m / 32) of the n_words
    words (one word where n_words is None); the bytes are the codes it
    reads, Peq, both length planes and the counts."""
    n_pat = pat_len.shape[0]
    read_steps = int(lens.clamp(0, width).sum())
    steps = n_pat * read_steps
    further = 0 if n_words is None else int(
        ((pat_len + 31) // 32).clamp(1, n_words).sum() - n_pat)
    ops = read_steps * (bench_myers.ISSUED_OPS * n_pat
                        + bench_myers.WORD_ISSUED_OPS * further)
    alu = read_steps * (bench_myers.ALU_OPS * n_pat
                        + bench_myers.WORD_ALU_OPS * further)
    nbytes = (read_steps + 4 * n_pat * (n_words or 1) * n_alpha
              + 4 * n_pat + 4 * lens.shape[0] + 4 * lens.shape[0] * n_pat)
    return steps, ops, alu, nbytes


def int_rates(mhz):
    """(issue, ALU-pipe) lane-operations a second of the whole card at
    the SM clock mhz."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r = bench_myers.peaks(torch.cuda.get_device_name(0))
    need(r is not None, "h100bench/alu_peaks.json has no row for "
         f"{torch.cuda.get_device_name(0)}")
    return (sms * r["issue_lanes_per_sm"] * mhz * 1e6,
            sms * r["alu_lanes_per_sm"] * mhz * 1e6)


def myers_bound_s(ops, alu, nbytes, mhz):
    """(seconds, "operations" or "bytes"): the least time of a Myers scan,
    the larger of its operations over the issue rate, its ALU-only
    operations over the ALU pipe's rate, and its bytes over 3.35 TB/s."""
    issue, pipe = int_rates(mhz)
    t_ops = max(ops / issue, alu / pipe)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def myers_cases_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_myers_cases", os.path.join(HERE, "tests",
                                          "torch_myers_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def myers_batch(rng, dev, *shape):
    """tests/torch_myers_cases.py planted_batch(rng, *shape) on dev."""
    import torch

    cases = myers_cases_module()
    return [torch.from_numpy(x).to(dev)
            for x in cases.planted_batch(rng, *shape)], cases.EVERY_LANE


def start_myers_baseline():
    """Start nvcc on the one-lane Myers kernel (scripts/myers_baseline.cu,
    csrc/myers.cu's earlier form, kept for timing) beside common.cu, into
    its own library under build/kmer_tpu_torch/; (path, process)."""
    from kmer_tpu_torch.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR,
                      f"libmyers_baseline.{os.getpid()}.so")
    return so, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
         MYERS_BASELINE, os.path.join(_build.CSRC, "common.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def myers_baseline_library(started):
    import ctypes

    so, proc = started
    _out, err = proc.communicate(timeout=600)
    need(proc.returncode == 0, f"nvcc of {MYERS_BASELINE} failed: {err}")
    return ctypes.CDLL(so)


def baseline_counts(lib, peq, plen, codes, lens, max_e, n_words=None):
    """The one-lane baseline kernel (a thread a lane, the masked step) on
    the same inputs: the (R, P) int32 counts."""
    import ctypes

    import torch

    P_, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    (R, L), P, n_alpha = codes.shape, plen.shape[0], peq.shape[-1]
    out = torch.empty((R, P), dtype=torch.int32, device=codes.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (peq.data_ptr(), plen.data_ptr(), codes.data_ptr(),
            lens.data_ptr())
    if n_words is None:
        fn = lib.ktt_myers
        fn.argtypes = [P_] * 4 + [I64] * 3 + [I32, I32, P_, P_]
        rc = fn(*ptrs, R, P, L, n_alpha, max_e, out.data_ptr(), stream)
    else:
        fn = lib.ktt_myers_multiword
        fn.argtypes = [P_] * 4 + [I64] * 3 + [I32] * 3 + [P_] * 3
        rc = fn(*ptrs, R, P, L, n_alpha, n_words, max_e, 0, out.data_ptr(),
                stream)
    need(rc == 0, f"the baseline myers kernel failed: CUDA error {rc}")
    return out


def myers_sass(symbol, steps, patterns, mhz, library=None):
    """(text, loop SASS a lane-step, ALU SASS a lane-step, issue bound s,
    ALU-pipe bound s) of a Myers kernel's loop over `steps` lane-steps,
    `patterns` lanes a thread; None where not measurable."""
    loop = sass_per_step(symbol, library)
    if loop is None or mhz is None:
        return None
    body, per_iter, alu = loop
    per = body / (per_iter * patterns)
    alu_per = alu / (per_iter * patterns)
    issue, pipe = int_rates(mhz)
    return (f"its loop is {body} SASS instructions ({alu} ALU-pipe) for "
            f"{per_iter} text step(s) x {patterns} pattern(s) = {per:.2f} a "
            f"lane-step ({alu_per:.2f} ALU)",
            per, alu_per, steps * per / issue, steps * alu_per / pipe)


def myers_rows(rows, rng, dev, baseline):
    """Both Myers kernels (csrc/myers.cu), in both forms (the (R, P)
    counts and the sum a pattern into an int64 total), against their
    plain versions on the card, lane for lane: every case of
    tests/torch_myers_cases.py; ed-vaf-counter's batch at 1,000 sites
    (2,048 reads of 150 bases in the 1,024 bucket x 2,000 patterns of 21
    bases, n_alpha 4 and a catch-all code) and at the 21,000-site panel
    (x 42,000 patterns); pattern lengths 0, 1, 21 and 32 on reads of
    0-4,096 bases; W = 2 on reads of 0-4,096 bases, W = 4 and W = 9 (the
    scratch form) with n_alpha 40; phase 11's long-pattern batch (2,048
    reads x 2 x LONG_SITES patterns of 45 and 97 bases, W = 4); each at
    its max_e and at EVERY_LANE, so that every lane's count is compared.
    The tool's shapes are timed in turns (CUDA events, a run of 5; the
    plain version at 42,000 patterns a run of 1) with the plain version
    and the one-lane kernel (`baseline`, scripts/myers_baseline.cu).
    Bound: the
    operations (myers_work) over the issue and ALU-pipe rates, beside
    the issue and ALU-pipe bounds of the compiled loop's SASS."""
    import torch

    from kmer_tpu_torch.kernels import myers

    def forms(n_words):
        if n_words is None:
            return (myers.build_peq, myers.myers_hw_counts_kernel,
                    myers.myers_hw_counts_plain, myers.myers_hw_sums_kernel,
                    myers.myers_hw_sums_plain, ())
        return ((lambda c, m, a: myers.build_peq_multiword(c, m, a,
                                                           n_words)),
                myers.myers_hw_counts_multiword_kernel,
                myers.myers_hw_counts_multiword_plain,
                myers.myers_hw_sums_multiword_kernel,
                myers.myers_hw_sums_multiword_plain, (n_words,))

    def check(label, pc, plen, codes, lens, n_alpha, n_words, max_e,
              every_lane, counts=True):
        """Both forms == plain at max_e and EVERY_LANE; the plain sums."""
        build, kern, plain, ksum, psum, more = forms(n_words)
        peq = build(pc, plen, n_alpha)
        found, e_max = [], 0.0
        for e in (max_e, every_lane):
            want = plain(peq, plen, codes, lens, e, *more)
            if counts:
                got = kern(peq, plen, codes, lens, e, *more)
                e_max = max(e_max, max_abs_err(got, want))
                del got
            P = plen.shape[0]
            total = ksum(peq, plen, codes, lens, e, *more,
                         torch.zeros(P, dtype=torch.int64, device=dev))
            e_max = max(e_max, max_abs_err(
                total, want.sum(0, dtype=torch.int64)))
            found.append(int(want.sum()))
            del want
        need(e_max == ERR_FREE, f"myers {label}: kernel != plain (max err "
             f"{e_max})")
        say("kernels", f"myers {label} ({codes.shape[0]} reads x "
            f"{plen.shape[0]} patterns, n_alpha {n_alpha}, W "
            f"{n_words or 1}): counts{' and' if counts else ''} sums equal "
            f"to plain, {found[0]} end locations at max_e {max_e}, "
            f"{found[1]} at max_e {every_lane}")
        return peq, e_max

    cases = myers_cases_module()
    err = {"myers": 0.0, "myers_multiword": 0.0}
    for name in sorted(cases.MYERS_CASES):
        pc, plen, codes, lens, n_alpha, n_words, max_e = cases.myers_case(
            name)
        t = [torch.from_numpy(x).to(dev) for x in (pc, plen, codes, lens)]
        _peq, e = check(name, *t, n_alpha, n_words, max_e, cases.EVERY_LANE)
        key = "myers" if n_words is None else "myers_multiword"
        err[key] = max(err[key], e)
    shapes = (
        # label, reads, pattern lengths, patterns, n_alpha, width, read
        # lengths, highest read code, words (None: one), max_e
        ("tool", 2048, [21], 2000, 4, 1024, (150, 150), 4, None, 1),
        ("panel", 2048, [21], 2 * SNP_SITES, 4, 1024, (150, 150), 4, None,
         1),
        ("m 0 1 21 32", 512, [0, 1, 21, 32], 96, 4, 4096, (0, 4096), 4,
         None, 2),
        ("W 2", 256, [5, 33, 64], 64, 40, 4096, (0, 4096), 45, 2, 2),
        ("W 4", 512, [45, 97, 128], 128, 40, 600, (0, 600), 45, 4, 1),
        ("W 9", 256, [33, 200, 288], 64, 40, 600, (0, 600), 45, 9, 2),
        ("long", 2048, list(LONG_K), 2 * LONG_SITES, 4, 1024, (150, 150), 4,
         4, 1),
    )
    mhz = sm_clock_mhz()
    timed = {}
    for (label, n_reads, pat_lens, n_pat, n_alpha, width, read_lens,
         code_max, n_words, max_e) in shapes:
        (pc, plen, codes, lens), every_lane = myers_batch(
            rng, dev, n_reads, pat_lens, n_pat, n_alpha, width, read_lens,
            code_max)
        key = "myers" if n_words is None else "myers_multiword"
        # at 42,000 patterns the sums only: the (R, P) form is the tool
        # batch's, and the plain counts' plane is 344 MB a pass
        peq, e = check(label, pc, plen, codes, lens, n_alpha, n_words,
                       max_e, every_lane, counts=label != "panel")
        err[key] = max(err[key], e)
        if label not in ("tool", "panel", "long"):
            continue
        build, kern, plain, ksum, psum, more = forms(n_words)
        total = torch.zeros(n_pat, dtype=torch.int64, device=dev)
        args = (peq, plen, codes, lens, max_e)
        runs = {
            "sums": (lambda: ksum(*args, *more, total), 5),
            "baseline": (lambda: baseline_counts(baseline, *args, n_words),
                         5),
            "plain": ((lambda: psum(*args, *more, total)) if label == "panel"
                      else (lambda: plain(*args, *more)),
                      1 if label == "panel" else 5)}
        if label != "panel":
            runs["counts"] = (lambda: kern(*args, *more), 5)
        names = list(runs)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            fn, reps = runs[n]
            ms[n].append(time_run_ms(fn, reps))
        work = myers_work(plen, lens, width, n_words, n_alpha)
        shape = myers.kernel_shape(n_reads, n_pat, n_alpha, n_words or 1,
                                   True, dev)
        timed[label] = (ms, work, n_words, shape)
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        bound_s, _by = myers_bound_s(*work[1:], mhz or 1980.0)
        say("kernels", f"myers {label} at the tool's shape ({work[0]} "
            f"lane-steps, W {n_words or 1}; {shape['patterns']} patterns a "
            f"thread, {shape['reads_a_warp']} reads a warp, grid "
            f"{shape['grid_x']} x {shape['grid_y']}, {shape['registers']} "
            "registers): " + "; ".join(
                f"{n} {' / '.join(f'{x:.4f}' for x in ms[n])} ms"
                for n in names)
            + f"; operation bound {bound_s * 1e3:.4f} ms")
        for n in ("sums", "counts"):
            if n in mean:
                say("kernels", f"myers {label}: {n} {mean[n]:.4f} ms against "
                    f"the baseline's {mean['baseline']:.4f} ms in the same "
                    f"turns ({mean['baseline'] / mean[n]:.2f}x)")
    for name, label, sym in (("myers", "panel", "myers_regsILi1E"),
                             ("myers_multiword", "long", "myers_regsILi4E")):
        ms, (steps, ops, alu, nbytes), n_words, shape = timed[label]
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        bound_s, by = myers_bound_s(ops, alu, nbytes, mhz or 1980.0)
        row = {"max_abs_err": err[name], "ms": mean["sums"],
               "plain_ms": mean["plain"], "bound_ms": bound_s * 1e3,
               "bound_by": by, "library_ms": None}
        rows[name] = row
        issue, pipe = int_rates(mhz or 1980.0)
        say("kernels", f"{name} (the sum form at phase 11's {label} shape, "
            f"{steps} lane-steps): {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.3f} ms; bound {row['bound_ms']:.4f} ms by "
            f"{by} ({ops} operations at {issue:.4g}/s issue, {alu} ALU-only "
            f"at {pipe:.4g}/s, the SM clock {mhz} MHz; bytes "
            f"{nbytes / 1e6:.1f} MB = {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
            f"ms); no one PyTorch call computes it")
        for who, lib, k in (("this kernel", None, shape["patterns"]),
                            ("the baseline kernel", baseline._name, 1)):
            mean_ms = mean["sums" if lib is None else "baseline"]
            got = myers_sass(sym, steps, k, mhz, lib)
            if got is None:
                say("kernels", f"{name}, {who}: SASS bounds not measured (no "
                    "cuobjdump, no loop over the read's codes or no SM "
                    "clock)")
                continue
            text, per, alu_per, issue_s, pipe_s = got
            top = max(issue_s, pipe_s) * 1e3
            say("kernels", f"{name}, {who}: {text}; issue bound "
                f"{issue_s * 1e3:.4f} ms, ALU-pipe bound {pipe_s * 1e3:.4f} "
                f"ms; {mean_ms:.4f} ms is {100 * top / mean_ms:.1f}% of the "
                f"larger")
        # the (R, P) form at the 1,000-site batch beside the baseline
        if label == "panel":
            tms, (tsteps, *_rest), _w, tshape = timed["tool"]
            tmean = {n: sum(v) / len(v) for n, v in tms.items()}
            got = myers_sass(sym, tsteps, tshape["patterns"], mhz)
            if got is not None:
                say("kernels", "myers tool batch: counts "
                    f"{tmean['counts']:.4f} ms, sums {tmean['sums']:.4f} ms, the baseline "
                    f"{tmean['baseline']:.4f} ms; issue bound "
                    f"{got[3] * 1e3:.4f} ms, ALU-pipe bound "
                    f"{got[4] * 1e3:.4f} ms")


def phase_kernels(seed):
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {}

    extract_rows(rows, rng, dev)
    seghist_rows(rows, g, dev)
    myers_rows(rows, rng, dev, myers_baseline_library(MYERS_BASELINE_BUILD))

    # the merge path for the three lane types (kernels 3-8 redesigned)
    merge_path_lane_types(rows, g, dev)

    torch.cuda.empty_cache()
    return rows


def watch_hist_bincount(eng):
    """Count the torch.bincount calls made inside eng's compactor.hist
    (into eng.hist_bincounts, None until hist runs): the fused segment
    histogram leaves none."""
    import torch

    inner = eng.compactor.hist

    def hist(*args, **kw):
        real, calls = torch.bincount, [0]

        def counted(*a, **k):
            calls[0] += 1
            return real(*a, **k)

        torch.bincount = counted
        try:
            return inner(*args, **kw)
        finally:
            torch.bincount = real
            eng.hist_bincounts = calls[0]

    eng.compactor.hist = hist
    eng.hist_bincounts = None
    return eng


def need_fused_hist(eng, launches, phase):
    """extract and seghist launched, and hist ran no bincount."""
    need(launches["extract"] > 0 and launches["seghist"] > 0,
         f"[{phase}] extract or seghist never launched: {launches}")
    need(eng.hist_bincounts == 0,
         f"[{phase}] the engine's hist ran {eng.hist_bincounts} bincounts")


@contextlib.contextmanager
def recording_engines(tool_module=None, plain_kernels=False):
    """Keep the engines that a tool module (kc by default) builds, to read
    their IngestStats; with plain_kernels, build them with the kernels'
    plain versions (the yak tap follows its engine's switch)."""
    from kmer_tpu_torch.pipeline.counter import SortCountEngine
    from kmer_tpu_torch.tools import kc

    mod = tool_module or kc
    made, real = [], mod.make_count_engine

    def record(k, block_bases=10_000_000, **kw):
        made.append(watch_hist_bincount(
            SortCountEngine(k, block_bases, plain_kernels=plain_kernels, **kw)
            if plain_kernels else real(k, block_bases=block_bases, **kw)))
        return made[-1]

    mod.make_count_engine = record
    try:
        yield made
    finally:
        mod.make_count_engine = real


def hist_text(eng):
    from kmer_tpu_torch.tools import kc

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kc._print_hist(eng.hist(256, max_count=None))
    return buf.getvalue()


def run_tool_err(tool, args):
    """(stdout, stderr) of one tool run, which must exit 0."""
    from kmer_tpu_torch.tools import get_tool

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = get_tool(tool)(args)
    need(rc == 0, f"{tool} {' '.join(args)} exited {rc}: "
         f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def run_tool(tool, args):
    """(stdout, the `[M` stderr lines) of one tool run, which must exit 0."""
    out, err = run_tool_err(tool, args)
    return out, [ln for ln in err.splitlines() if ln.startswith("[M")]


def run_kc_c4(args):
    return run_tool("kc-c4", args)[0]


def check_hist_text(text):
    rows = [line.split("\t") for line in text.splitlines()]
    need(len(rows) == 255 and all(len(r) == 2 for r in rows),
         "kc-c4 output is not 255 count/distinct rows")
    need([int(r[0]) for r in rows] == list(range(1, 256)),
         "kc-c4 output rows are not numbered 1..255")
    vals = [int(r[1]) for r in rows]
    need(all(v >= 0 for v in vals) and sum(vals) > 0,
         "kc-c4 output has negative or no distinct k-mers")
    return sum(vals)


def phase_e2e(seed):
    import torch

    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    t0 = time.perf_counter()
    path = reads_file(MBASES, seed)
    say("e2e", f"reads {os.path.relpath(path, HERE)} "
        f"({os.path.getsize(path) / 1e6:.0f} MB gz) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN
    # earlier phases' engines are reference cycles (compactor <-> ladder
    # callbacks): free their device memory before the peak is read
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with recording_engines() as made:
        t0 = time.perf_counter()
        out = run_kc_c4([f"-k{K}", path])
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    eng = made[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    need(eng.total_bases == bases,
         f"engine counted {eng.total_bases} bases, file has {bases}")
    n_distinct = check_hist_text(out)
    need(n_distinct == eng._n_distinct, "printed distinct != engine's")
    say("e2e", f"kc-c4 -k{K} {MBASES} Mbases: {wall:.3f} s = "
        f"{bases / 1e6 / wall:.2f} Mbases/s, {eng.total_kmers} k-mers, "
        f"{n_distinct} distinct (bins 1..255), peak device memory "
        f"{peak:.2f} GiB")
    say("e2e", f"IngestStats: {stats_line(eng.stats)}; finalize (hist) "
        f"{wall - eng.stats.loop_s:.3f} s")
    say("e2e", f"launches in this run: {json.dumps(launches)}")
    need(all(launches[name] > 0 for name in KC_PATH_KERNELS),
         f"a kernel of the path was never launched: {launches}")
    need_fused_hist(eng, launches, "e2e")

    plain = SortCountEngine(K, qual_policy=("resume", K, 3),
                            plain_kernels=True)
    t0 = time.perf_counter()
    plain.count_paths([path])
    want = hist_text(plain)
    pwall = time.perf_counter() - t0
    need(out == want, "kc-c4 with kernels != the plain versions on the card")
    say("e2e", f"plain versions on the card: same output, {pwall:.3f} s = "
        f"{bases / 1e6 / pwall:.2f} Mbases/s ({stats_line(plain.stats)})")
    return {"launches": launches, "out": out, "wall": wall,
            "stats": eng.stats, "peak": peak}


def phase_budget(seed):
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    path = reads_file(32, seed + 1)
    texts = []
    for plain_kernels in (False, True):
        eng = SortCountEngine(K, budget_bytes=64 << 20,
                              plain_kernels=plain_kernels)
        eng.count_paths([path])
        runs = eng.compactor.runs
        need(runs and runs[0][1] is not None,
             "the budget never tripped a compaction")
        texts.append(hist_text(eng))
    need(texts[0] == texts[1], "budget-trip histogram: kernels != plain")
    say("budget", f"32 Mbases, 64 MiB budget: compacted "
        f"({eng.compactor.last_n_unique} distinct at the last trip), "
        f"kernels == plain, {check_hist_text(texts[0])} distinct")


@contextlib.contextmanager
def setenv(name, value):
    """Set one environment variable for the block, restoring it after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def platform(name):
    """Run the tools on KMER_TPU_PLATFORM=name (kmer_tpu_torch's device
    rule)."""
    return setenv("KMER_TPU_PLATFORM", name)


def packed_ingest():
    """Run the engines with packed 2-bit ingest (KMER_TPU_PACKED=1)."""
    return setenv("KMER_TPU_PACKED", "1")


def fixture_snp_chain():
    """The four SNP tools on tests/fixtures (genome_small.fa.gz and
    snps_small.bed over sampleA1/A2/B.fq.gz): every file the port writes
    on the GPU equals the file it writes on the CPU."""
    fix = os.path.join(HERE, "tests", "fixtures")
    fqs = {s: os.path.join(fix, f"{s}.fq.gz")
           for s in ("sampleA1", "sampleA2", "sampleB")}
    runs = {}
    for plat in ("cuda", "cpu"):
        d = os.path.join(DATA_DIR, f"fixture_snp_{plat}")
        with platform(plat):
            runs[plat] = run_snp_chain(d, snp_chain(
                d, os.path.join(fix, "genome_small.fa.gz"),
                os.path.join(fix, "snps_small.bed"), fqs))[1]
    need(sorted(runs["cuda"]) == sorted(runs["cpu"]) and len(runs["cpu"]) == 7,
         f"fixture SNP chain files: {sorted(runs['cuda'])}")
    for fn in runs["cpu"]:
        need(runs["cuda"][fn] == runs["cpu"][fn],
             f"fixture SNP chain {fn}: GPU bytes != CPU bytes")
    status = match_status(runs["cuda"]["samples.match"].decode())
    need(list(status.values()).count("MATCHED") == 1,
         f"fixture classifier: {status}")
    say("fixture", f"SNP chain on tests/fixtures (snp-pattern-gen, "
        f"vaf-counter x3, correlation-matrix -t, match-classifier -v -P): "
        f"GPU == CPU for all {len(runs['cpu'])} files; "
        f"sampleA1-sampleA2 the one matched pair")


def fixture_packed(name, k, ascii_out):
    """kc-c4 -k<k> on a fixture under packed ingest, on the GPU and on the
    CPU: both equal the ASCII path's output, and the blocks that hold
    N bases or varied lengths take the masked step."""
    path = os.path.join(HERE, "tests", "fixtures", name)
    with packed_ingest(), counting_packed_steps() as steps:
        gpu = run_kc_c4([f"-k{k}", path])
        with platform("cpu"):
            cpu = run_kc_c4([f"-k{k}", path])
    need(gpu == cpu == ascii_out,
         f"fixture {name} k={k} packed: GPU, CPU and ASCII path differ")
    need(steps["masked"] > 0, f"fixture {name} packed: no masked block")
    say("fixture", f"{name} kc-c4 k={k} packed: GPU == CPU == ASCII path "
        f"({steps['masked']} masked, {steps['structural']} structural "
        "blocks)")


def phase_fixture():
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    kc_out = {}
    for name in ("reads_small.fq.gz", "genome_small.fa.gz"):
        path = os.path.join(HERE, "tests", "fixtures", name)
        for k in (15, 21, 31):
            gpu = kc_out[name, k] = run_kc_c4([f"-k{k}", path])
            cpu = SortCountEngine(k, qual_policy=("resume", k, 3),
                                  device="cpu")
            cpu.count_paths([path])
            need(gpu == hist_text(cpu),
                 f"fixture {name} k={k}: GPU bytes != CPU bytes")
            say("fixture", f"{name} kc-c4 k={k}: GPU == CPU "
                f"({check_hist_text(gpu)} distinct)")
            if k != 21:
                fixture_packed(name, k, gpu)
    fixture_snp_chain()
    fix = os.path.join(HERE, "tests", "fixtures")
    path = os.path.join(fix, "reads_small.fq.gz")
    for args in (["-k21", "-b19", "-K30000"], ["-k15", "-b20"]):
        gpu = run_tool("yak-count", [*args, path])
        with platform("cpu"):
            cpu = run_tool("yak-count", [*args, path])
        need(gpu == cpu, f"fixture yak-count {' '.join(args)}: GPU != CPU")
        check_yak_text(gpu)
        say("fixture", f"reads_small.fq.gz yak-count {' '.join(args)}: "
            f"GPU == CPU (stdout and {len(gpu[1])} [M lines; "
            f"{gpu[1][-1]})")
        with packed_ingest(), counting_packed_steps() as steps:
            gpu_p = run_tool("yak-count", [*args, path])
            with platform("cpu"):
                cpu_p = run_tool("yak-count", [*args, path])
        need(gpu_p == cpu_p == gpu and steps["masked"] > 0,
             f"fixture yak-count {' '.join(args)} packed: GPU, CPU and "
             f"ASCII path differ, or no masked block ({steps})")
        say("fixture", f"reads_small.fq.gz yak-count {' '.join(args)} "
            f"packed: GPU == CPU == ASCII path ({steps['masked']} masked "
            "blocks)")
    a1, b = (os.path.join(fix, f"{s}.fq.gz") for s in ("sampleA1", "sampleB"))
    for args in (["-k31", "-b19", "-K65536"], ["-k15", "-b19"], ["-b0"]):
        gpu = run_tool("yak-count", [*args, a1, b])
        with platform("cpu"):
            cpu = run_tool("yak-count", [*args, a1, b])
        need(gpu == cpu, f"fixture two-file yak-count {' '.join(args)}: "
             "GPU != CPU")
        check_yak_text(gpu)
        say("fixture", f"sampleA1 + sampleB yak-count {' '.join(args)}: "
            f"GPU == CPU (stdout and {len(gpu[1])} [M lines; {gpu[1][-1]})")
    pat = os.path.join(DATA_DIR, "fixture_snp_cpu", "snps.pat")
    for e in (0, 1, 2):
        vafs = []
        for plat in ("cuda", "cpu"):
            vaf = os.path.join(DATA_DIR, f"fixture_ed_e{e}_{plat}.vaf")
            with platform(plat):
                run_tool_err("ed-vaf-counter", [f"-e{e}", "-p", pat, "-o",
                                                vaf, a1])
            vafs.append(read_file(vaf))
        need(vafs[0] == vafs[1], f"fixture ed-vaf-counter -e{e}: GPU != CPU")
        say("fixture", f"sampleA1 ed-vaf-counter -e{e} on the fixture "
            f"patterns: GPU == CPU ({vafs[0].splitlines()[0].decode()})")
    return {"kc": kc_out}


def check_yak_text(result):
    """yak-count's 1023 rows numbered 1..1023, and its last `[M` line
    giving their sum."""
    text, mlines = result
    rows = [line.split("\t") for line in text.splitlines()]
    need(len(rows) == 1023 and all(len(r) == 2 for r in rows)
         and [int(r[0]) for r in rows] == list(range(1, 1024)),
         "yak-count output is not 1023 numbered count/distinct rows")
    total = sum(int(r[1]) for r in rows)
    need(total > 0 and all(int(r[1]) >= 0 for r in rows),
         "yak-count output has negative or no distinct k-mers")
    need(mlines and mlines[-1] == f"[M::main] {total} distinct k-mers "
         "after shrinking", f"yak-count's last [M line does not give "
         f"{total}: {mlines[-1:]}")
    return total


@contextlib.contextmanager
def recording_taps():
    """Keep the admission taps that yak-count builds, and time their
    finalization (the deferred admission's sorts, ending in a readback)."""
    from kmer_tpu_torch.tools import yak_count

    made, real = [], yak_count.YakSimTap

    class Tap(real):
        finish_s = None

        def finish_batches(self):
            t0 = time.perf_counter()
            super().finish_batches()
            self.finish_s = time.perf_counter() - t0

    def record(*a, **kw):
        made.append(Tap(*a, **kw))
        return made[-1]

    yak_count.YakSimTap = record
    try:
        yield made
    finally:
        yak_count.YakSimTap = real


YAK_ARGS = ["-k31", "-b30"]


def phase_yak(seed):
    import torch

    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.tools import yak_count

    path = reads_file(MBASES, seed)
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN
    args = [*YAK_ARGS, path]
    # earlier phases' engines are reference cycles (compactor <-> ladder
    # callbacks): free their device memory before the peak is read
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with recording_engines(yak_count) as made, recording_taps() as taps:
        t0 = time.perf_counter()
        got = run_tool("yak-count", args)
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng, tap = made[0], taps[0]
    need(eng.total_bases == bases,
         f"engine counted {eng.total_bases} bases, file has {bases}")
    need(not eng.plain_kernels, "the yak engine is not on the kernels")
    total = check_yak_text(got)
    n_batches = len(tap.batch_seq_counts)
    need(len(got[1]) == 2 * n_batches + 1 and n_batches > 1,
         f"{len(got[1])} [M lines for {n_batches} batches")
    need(sum(tap.batch_seq_counts) == eng.total_seqs,
         "the [M lines do not add up to the reads counted")
    flags = " ".join(YAK_ARGS)
    say("yak", f"yak-count {flags} {MBASES} Mbases: {wall:.3f} s = "
        f"{bases / 1e6 / wall:.2f} Mbases/s, {total} distinct after "
        f"shrinking, {tap.tot} admitted in pass 1, {n_batches} batches, "
        f"peak device memory {peak:.2f} GiB, tap budget trips "
        f"{tap.budget_trips}")
    say("yak", f"IngestStats: {stats_line(eng.stats)}; tap finalize "
        f"{tap.finish_s:.3f} s; engine finalize (hist) "
        f"{wall - eng.stats.loop_s - tap.finish_s:.3f} s")
    say("yak", f"launches in this run: {json.dumps(launches)}")
    need(all(launches[name] > 0 for name in
             (*KC_PATH_KERNELS, *YAK_TAP_KERNELS)),
         f"a kernel of the yak path was never launched: {launches}")
    need_fused_hist(eng, launches, "yak")

    with recording_engines(yak_count, plain_kernels=True) as made:
        t0 = time.perf_counter()
        want = run_tool("yak-count", args)
        pwall = time.perf_counter() - t0
    need(made[0].plain_kernels, "the plain run did not use plain versions")
    need(got == want, "yak-count with kernels != the plain versions on the "
         "card (stdout or [M lines)")
    say("yak", f"plain versions on the card (engine and tap): same stdout "
        f"and [M lines, {pwall:.3f} s = {bases / 1e6 / pwall:.2f} Mbases/s")
    return {"launches": launches, "got": got, "wall": wall}


@contextlib.contextmanager
def counting_packed_steps():
    """Count the engine's packed extraction steps while the block runs:
    {"masked": n, "structural": n} (a block whose mask was elided takes
    the structural step)."""
    from kmer_tpu_torch.pipeline import counter

    steps = {"masked": 0, "structural": 0}
    real = {}
    for name, key in (("_extract_step_packed", "masked"),
                      ("_extract_step_packed_structural", "structural")):
        real[name] = getattr(counter, name)

        def step(*a, _fn=real[name], _key=key):
            steps[_key] += 1
            return _fn(*a)

        setattr(counter, name, step)
    try:
        yield steps
    finally:
        for name, fn in real.items():
            setattr(counter, name, fn)


def unpack_rows(path):
    """Unpack the first 10 Mbase block of path on the card, with its mask
    and without (structural), against the ASCII reader's block; returns
    {form: (ms, bound_ms)} with the device time a block (CUDA events)."""
    import torch

    from kmer_tpu_torch import default_device
    from kmer_tpu_torch.io import native
    from kmer_tpu_torch.pipeline import counter

    block = 10_000_000
    cap = block + max(4096, block // 32)
    packed, mask, n, _, _, rb, _ = next(native.iter_packed2bit_native(
        [path], K, block, cap, ("resume", K, 3)))
    ascii_block = next(native.iter_packed_native(
        [path], K, block, cap, ("resume", K, 3)))[0]
    dev = default_device()
    p, m = torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev)
    forms = {"masked": (lambda: counter._unpack_ascii(p, m),
                        packed.nbytes + mask.nbytes),
             "structural": (lambda: counter._structural_ascii(p, n, rb),
                            packed.nbytes)}
    want = torch.zeros(4 * packed.shape[0], dtype=torch.uint8)
    want[:ascii_block.shape[0]] = torch.from_numpy(ascii_block)
    out = {}
    for form, (fn, nbytes) in forms.items():
        got = fn().cpu()
        need(torch.equal(got, want),
             f"{form} unpack != the ASCII reader's block")
        out[form] = (time_run_ms(fn, reps=20),
                     (nbytes + got.numel()) / HBM_BYTES_PER_S * 1e3)
    return out, n, rb


def phase_packed(seed, e2e, yak):
    """kc-c4 -k31 and yak-count -k31 -b30 on the 256 Mbase file under
    KMER_TPU_PACKED=1: the same bytes as phases 4 and 6, every block
    structural, the path's kernels launched."""
    import torch

    from kmer_tpu_torch.kernels import _build

    path = reads_file(MBASES, seed)
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN
    gc.collect()
    torch.cuda.synchronize()
    _build.reset_launches()
    with packed_ingest(), counting_packed_steps() as steps, \
            recording_engines() as made:
        t0 = time.perf_counter()
        out = run_kc_c4([f"-k{K}", path])
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    with packed_ingest():
        kc_staged = staged(lambda: run_kc_c4([f"-k{K}", path]))
    st = made[0].stats
    need(out == e2e["out"], "kc-c4 packed != kc-c4 ASCII (phase 4)")
    need(steps["masked"] == 0 and steps["structural"] > 0,
         f"kc-c4 packed: not every block was structural ({steps})")
    need(all(launches[name] > 0 for name in KC_PATH_KERNELS),
         f"kc-c4 packed: a kernel of the path was never launched: "
         f"{launches}")
    need_fused_hist(made[0], launches, "packed")
    say("packed", f"kc-c4 -k{K} {MBASES} Mbases packed: same output as "
        f"phase 4, {steps['structural']} blocks all structural; {wall:.3f} "
        f"s = {bases / 1e6 / wall:.2f} Mbases/s (ASCII {e2e['wall']:.3f} s "
        f"= {bases / 1e6 / e2e['wall']:.2f}); staged {kc_staged['bytes']} "
        f"bytes ({kc_staged['bytes'] / bases:.4f} a base) in "
        f"{kc_staged['s']:.3f} s (a second pass, traced)")
    say("packed", f"IngestStats: {stats_line(st)}")
    say("packed", f"launches in this run: {json.dumps(launches)}")

    _build.reset_launches()
    with packed_ingest(), counting_packed_steps() as ysteps:
        t0 = time.perf_counter()
        got = run_tool("yak-count", [*YAK_ARGS, path])
        ywall = time.perf_counter() - t0
    ylaunches = dict(_build.LAUNCHES)
    with packed_ingest():
        ystaged = staged(lambda: run_tool("yak-count", [*YAK_ARGS, path]))
    need(got == yak["got"], "yak-count packed != yak-count ASCII (phase 6: "
         "stdout or [M lines)")
    need(ysteps["masked"] == 0 and ysteps["structural"] > 0,
         f"yak-count packed: not every block was structural ({ysteps})")
    need(all(ylaunches[name] > 0 for name in
             (*KC_PATH_KERNELS, *YAK_TAP_KERNELS)),
         f"yak-count packed: a kernel of the path never launched: "
         f"{ylaunches}")
    say("packed", f"yak-count {' '.join(YAK_ARGS)} packed: same stdout and "
        f"{len(got[1])} [M lines as phase 6; {ywall:.3f} s = "
        f"{bases / 1e6 / ywall:.2f} Mbases/s (ASCII {yak['wall']:.3f} s); "
        f"staged {ystaged['bytes']} bytes (a second pass, traced)")
    say("packed", f"launches in this run: {json.dumps(ylaunches)}")

    rows, n, rb = unpack_rows(path)
    for form, (ms, bound) in rows.items():
        say("packed", f"unpack, {form}, one block of {n} bytes (rows of "
            f"{rb}): {ms:.4f} ms device time, bound {bound:.4f} ms "
            f"(bytes), share {bound / ms:.1%}; == the ASCII reader's block")
    return {"launches": launches, "yak_launches": ylaunches}


def phase_onepl(seed):
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    path = reads_file(32, seed + 1)
    k = 15
    out = {}
    for plain_kernels in (False, True):
        _build.reset_launches()
        eng = watch_hist_bincount(SortCountEngine(
            k, budget_bytes=64 << 20, qual_policy=("resume", k, 3),
            plain_kernels=plain_kernels))
        need(eng.compactor.one_plane,
             "k=15 does not run the one-plane stream ladder")
        t0 = time.perf_counter()
        eng.count_paths([path])
        text = hist_text(eng)
        out[plain_kernels] = (text, time.perf_counter() - t0,
                              dict(_build.LAUNCHES))
        if not plain_kernels:
            need_fused_hist(eng, out[False][2], "onepl")
    need(out[False][0] == out[True][0], "kc-c4 -k15: kernels != plain")
    launches = out[False][2]
    need(all(launches[name] > 0 for name in ONE_PLANE_KERNELS),
         f"the one-plane merge kernels never launched: {launches}")
    need(not any(launches[name] for name in
                 ("merge_partition", "merge_path")),
         f"k=15 ran a two-plane merge: {launches}")
    # the budget trips fold their compacted (key, count) runs by merge path
    need(all(launches[name] > 0 for name in YAK_TAP_KERNELS),
         f"k=15's budget trips did not fold by the (key, count) merge "
         f"path: {launches}")
    need(not any(out[True][2].values()), "the plain run launched kernels")
    say("onepl", f"kc-c4 -k15 32 Mbases, 64 MiB budget: kernels == plain "
        f"({check_hist_text(out[False][0])} distinct), {out[False][1]:.3f} "
        f"s vs plain {out[True][1]:.3f} s")
    say("onepl", f"launches in this run: {json.dumps(launches)}")
    return {"launches": launches, "out": out[False][0]}


# -- the SNP-fingerprint pipeline -----------------------------------------

SNP_SITES = 21_000  # NGSCheckMate's panel size (bench.py:80, N_SNPS)
SNP_K = 21
# sample, genotype, Mbases, read seed: A and A2 are one individual (X)
SNP_SAMPLES = (("A", "X", 256, 1), ("A2", "X", 64, 2), ("B", "Y", 64, 3))
N_CHROMS = 24


def snp_inputs(seed):
    """(genome FASTA, BED, {sample: FASTQ}), made from seed and cached:
    the smoke's 24 MiB genome cut into 24 chromosomes of seeded lengths;
    SNP_SITES sites at seeded positions at least 32 bases apart, each
    with a seeded alt base; genotypes X and Y each homozygous for the alt
    base at their own seeded half of the sites; 150 bp reads with 0.5%
    errors sampled from each sample's genotype."""
    import numpy as np

    tag = f"s{seed}"
    fasta = os.path.join(DATA_DIR, f"snp_genome_{tag}.fa.gz")
    bed = os.path.join(DATA_DIR, f"snp_sites_{tag}.bed")
    fqs = {name: os.path.join(DATA_DIR, f"snp_{name}_{mb}M_{tag}.fq.gz")
           for name, _, mb, _ in SNP_SAMPLES}
    if all(os.path.exists(p) for p in (fasta, bed, *fqs.values())):
        return fasta, bed, fqs
    os.makedirs(DATA_DIR, exist_ok=True)
    genome, _ = genome_codes(seed)
    rng = np.random.default_rng([seed, 6])
    cuts = np.sort(rng.choice(np.arange(1 << 16, GENOME_BASES - (1 << 16)),
                              N_CHROMS - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [GENOME_BASES]])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    tmp = f"{fasta}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        comp = zlib.compressobj(1, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        for c in range(N_CHROMS):
            seq = acgt[genome[bounds[c]:bounds[c + 1]]]
            body = b"\n".join(seq[i:i + 80].tobytes()
                              for i in range(0, seq.shape[0], 80))
            f.write(comp.compress(b">chr%d\n" % (c + 1) + body + b"\n"))
        f.write(comp.flush())
    os.replace(tmp, fasta)
    # sites on a 32-base grid, kept 16 bases from every chromosome end
    grid = np.arange(16, GENOME_BASES, 32)
    chrom = np.searchsorted(bounds, grid, side="right") - 1
    ok = (grid - bounds[chrom] >= 16) & (bounds[chrom + 1] - grid > 16)
    pick = np.sort(rng.choice(np.flatnonzero(ok), SNP_SITES, replace=False))
    pos, chrom = grid[pick], chrom[pick]
    ref = genome[pos]
    alt = (ref + rng.integers(1, 4, SNP_SITES)) % 4
    with open(bed, "w") as f:
        for i in range(SNP_SITES):
            start = int(pos[i] - bounds[chrom[i]])
            f.write(f"chr{chrom[i] + 1}\t{start}\t{start + 1}\trs{i + 1}\t"
                    f"{'ACGT'[ref[i]]}\t{'ACGT'[alt[i]]}\n")
    halves = {g: rng.permutation(SNP_SITES)[:SNP_SITES // 2] for g in "XY"}
    for name, g, mb, read_seed in SNP_SAMPLES:
        variant = genome.copy()
        variant[pos[halves[g]]] = alt[halves[g]]
        write_reads(fqs[name], variant, mb,
                    np.random.default_rng([seed, 7, read_seed]))
    return fasta, bed, fqs


def snp_chain(d, fasta, bed, fqs):
    """The four SNP tools, in order, as (tool, args) with their outputs in
    directory d: patterns, one VAF file a sample, the correlation matrix
    (+ tree), and the classifier's pairs (predefined model, all pairs)."""
    vafs = [os.path.join(d, f"{name}.vaf") for name in fqs]
    return [
        ("snp-pattern-gen", [f"-k{SNP_K}", "-b", bed, "-f", fasta, "-o",
                             os.path.join(d, "snps.pat")]),
        *[("vaf-counter", [f"-k{SNP_K}", "-v", "-p",
                           os.path.join(d, "snps.pat"), "-o", vaf, fq])
          for vaf, fq in zip(vafs, fqs.values())],
        ("correlation-matrix", ["-o", os.path.join(d, "samples.corr"), "-t",
                                *vafs]),
        ("match-classifier", ["-c", os.path.join(d, "samples.corr"), "-o",
                              os.path.join(d, "samples.match"), "-v", "-P",
                              *vafs]),
    ]


def run_snp_chain(d, chain):
    """Run the chain in a fresh directory d: (stderr, wall s, peak device
    GiB, device GiB held before it) of each tool run (no device numbers
    under KMER_TPU_PLATFORM=cpu), and {file name: bytes} of what it
    wrote."""
    import torch

    os.makedirs(d, exist_ok=True)
    for fn in os.listdir(d):
        os.remove(os.path.join(d, fn))
    cuda = os.environ.get("KMER_TPU_PLATFORM", "") != "cpu"
    runs = []
    for tool, args in chain:
        held = None
        if cuda:
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        err = run_tool_err(tool, args)[1]
        wall = time.perf_counter() - t0
        runs.append((err, wall, torch.cuda.max_memory_allocated() / 2**30
                     if cuda else None, held))
    files = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            files[fn] = f.read()
    return runs, files


def match_status(text):
    """{frozenset(sample pair): status} from match-classifier -v."""
    out = {}
    for line in text.splitlines():
        t = line.split("\t")
        if len(t) == 7 and t[6] in ("MATCHED", "UNMATCHED"):
            out[frozenset(t[:2])] = t[6]
    return out


@contextlib.contextmanager
def timing_counts_for():
    """Record (engine, host seconds) of every SortCountEngine.counts_for
    call (its result ends in a readback, so the wall holds the device
    work)."""
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    calls, real = [], SortCountEngine.counts_for

    def counts_for(self, *a):
        t0 = time.perf_counter()
        out = real(self, *a)
        calls.append((self, time.perf_counter() - t0))
        return out

    SortCountEngine.counts_for = counts_for
    try:
        yield calls
    finally:
        SortCountEngine.counts_for = real


VAF_V_LINES = ("runtime", "loading", "creation", "counting", "writing",
               "Speed", "throughput", "Bases processed", "Device")


def phase_snp(seed, card):
    import numpy as np
    import torch

    from kmer_tpu_torch.io.formats import read_patterns
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.kernels.keys import from_hi_lo
    from kmer_tpu_torch.tools import snp_pattern_gen, vaf_counter

    say("snp", f"on {card}")
    t0 = time.perf_counter()
    fasta, bed, fqs = snp_inputs(seed)
    say("snp", f"inputs ready in {time.perf_counter() - t0:.1f} s: "
        f"{SNP_SITES} sites, genome {os.path.getsize(fasta) / 1e6:.0f} MB "
        "gz, " + ", ".join(f"{name} {mb} Mbases"
                           for name, _, mb, _ in SNP_SAMPLES))
    card_dir = os.path.join(DATA_DIR, "snp_card")
    chain = snp_chain(card_dir, fasta, bed, fqs)
    gc.collect()
    torch.cuda.synchronize()
    _build.reset_launches()
    with recording_engines(snp_pattern_gen) as made_s, \
            recording_engines(vaf_counter) as made_v, \
            timing_counts_for() as cf_calls:
        runs, files = run_snp_chain(card_dir, chain)
    launches = dict(_build.LAUNCHES)
    say("snp", f"launches in this run: {json.dumps(launches)}")
    need(all(launches[n] > 0 for n in
             ("extract", "merge_partition", "merge_path")),
         f"the SNP chain did not launch extract and the merge path: "
         f"{launches}")
    need(not launches["seghist"] and not any(
        launches[n] for n in (*ONE_PLANE_KERNELS, *YAK_TAP_KERNELS)),
         f"the SNP chain launched seghist or another merge: {launches}")
    need(len(made_s) == 1 and len(made_v) == len(SNP_SAMPLES)
         and not any(e.plain_kernels for e in made_s + made_v),
         "the SNP tools did not count on card engines")
    patterns = read_patterns(os.path.join(card_dir, "snps.pat"))
    need(len(patterns) > SNP_SITES * 0.9,
         f"only {len(patterns)} of {SNP_SITES} sites kept")
    status = match_status(files["samples.match"].decode())
    need(status == {frozenset(("A", "A2")): "MATCHED",
                    frozenset(("A", "B")): "UNMATCHED",
                    frozenset(("A2", "B")): "UNMATCHED"},
         f"classifier: {status}")
    for (tool, args), (_, wall, peak, held) in zip(chain, runs):
        on = (f" {os.path.basename(args[-1])}" if tool == "vaf-counter"
              else "")
        say("snp", f"{tool}{on}: {wall:.3f} s, "
            f"peak device memory {peak:.2f} GiB ({held:.2f} GiB held "
            "before it by earlier tools' engines)")
    say("snp", f"snp-pattern-gen kept {len(patterns)} of {SNP_SITES} sites; "
        "classifier: A-A2 MATCHED, A-B and A2-B UNMATCHED")
    for line in runs[1][0].splitlines():
        if any(w in line for w in VAF_V_LINES):
            say("snp", f"vaf-counter A -v: {line.strip()}")

    # counts_for over A's key plane: the call in vaf-counter (which folds
    # the stream ladder into one plane first), then calls on that plane
    eng, first_s = cf_calls[1]
    need(eng is made_v[0], "the second counts_for call is not A's")
    phi, plo, _, n_map = vaf_counter.create_combined_kmer_map(patterns,
                                                              SNP_K)
    keys = eng.compactor._stream_keys()
    n_lanes = int(keys.shape[0])
    want = eng.compactor.counts_for(phi[:n_map], plo[:n_map])
    again = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.compactor.counts_for(phi[:n_map], plo[:n_map])
        again.append(time.perf_counter() - t0)
        need(np.array_equal(got, want), "counts_for differs between calls")
    q = from_hi_lo(phi[:n_map], plo[:n_map], keys.device)
    search_ms = time_run_ms(lambda: (torch.searchsorted(keys, q),
                                     torch.searchsorted(keys, q, right=True)))
    plane_ms = n_lanes * 8 / HBM_BYTES_PER_S * 1e3
    probe_bytes = 2 * n_map * n_lanes.bit_length() * 32
    say("snp", f"counts_for, {n_map} queries over A's plane of {n_lanes} "
        f"lanes: {first_s * 1e3:.3f} ms in vaf-counter (ladder fold "
        f"included), {min(again) * 1e3:.3f} ms a call on the folded plane "
        f"(host wall: upload, two searchsorted, readback), "
        f"{search_ms:.4f} ms for the two searchsorted (device, a run of 5); "
        f"bound: the plane read once {plane_ms:.4f} ms; the probes' 32-byte "
        f"sectors {probe_bytes / 1e6:.1f} MB = "
        f"{probe_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del eng, keys, q, made_s, made_v, cf_calls
    gc.collect()
    torch.cuda.empty_cache()

    plain_dir = os.path.join(DATA_DIR, "snp_plain")
    with recording_engines(snp_pattern_gen, plain_kernels=True) as made_s, \
            recording_engines(vaf_counter, plain_kernels=True) as made_v:
        plain_runs, plain_files = run_snp_chain(
            plain_dir, snp_chain(plain_dir, fasta, bed, fqs))
    need(len(made_s) == 1 and all(e.plain_kernels for e in made_s + made_v),
         "the plain run did not use plain versions")
    need(sorted(plain_files) == sorted(files),
         f"files {sorted(plain_files)} != {sorted(files)}")
    for fn in files:
        need(files[fn] == plain_files[fn],
             f"{fn}: card kernels != the plain versions on the card")
    say("snp", f"plain versions on the card: every file equal "
        f"({', '.join(sorted(files))}); vaf-counter A "
        f"{plain_runs[1][1]:.3f} s vs {runs[1][1]:.3f} s with the kernels")
    return launches


# -- two-file yak-count and ed-vaf-counter --------------------------------

YAK2_ARGS = ["-k31", "-b30"]
# the two-file path runs extract, the bloom's test-and-set, the int64
# merge path, and the (key, count) merge path: pass 1 compacts every
# batch, and each fold after the first merges into the standing plane
YAK2_KERNELS = ("extract", "bloom", "merge_partition", "merge_path",
                *YAK_TAP_KERNELS)


@contextlib.contextmanager
def recording_yak_engines(plain_kernels=False):
    """Keep the engines that yak-count's two-file branch builds; with
    plain_kernels, build them with the kernels' plain versions (both
    compactors and extraction)."""
    from kmer_tpu_torch.pipeline.yak import SortYakEngine
    from kmer_tpu_torch.tools import yak_count

    made, real = [], yak_count.make_yak_engine

    def record(**kw):
        made.append(SortYakEngine(plain_kernels=plain_kernels, **kw))
        return made[-1]

    yak_count.make_yak_engine = record
    try:
        yield made
    finally:
        yak_count.make_yak_engine = real


@contextlib.contextmanager
def timing_yak2():
    """Time the two-file engine's bloom and join: every bloom.admit call
    (csrc/bloom.cu) between two CUDA events (no synchronize, so the
    pipeline runs as it would; the events also count any wait for the
    host inside the call), and the shrink join between two synchronizes
    (host wall)."""
    import torch

    from kmer_tpu_torch.kernels import bloom
    from kmer_tpu_torch.pipeline import yak

    times = {"insert": [], "join_s": []}
    real_ins, real_join = bloom.admit, yak._shrink_join_core

    def admit(bits, keys, spec, *a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_ins(bits, keys, spec, *a)
        ev[1].record()
        times["insert"].append((ev, keys.shape[0], spec.n_hashes))
        return out

    def shrink_join(keys1, keys2, c2, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_join(keys1, keys2, c2, *a)
        torch.cuda.synchronize()
        times["join_s"].append(time.perf_counter() - t0)
        times["join_lanes"] = (keys1.shape[0], keys2.shape[0])
        return out

    bloom.admit = admit
    yak._shrink_join_core = shrink_join
    try:
        yield times
    finally:
        bloom.admit, yak._shrink_join_core = real_ins, real_join


def phase_yak2(seed):
    import torch

    from kmer_tpu_torch.kernels import _build

    path_a = reads_file(MBASES, seed)
    path_b = snp_inputs(seed)[2]["B"]
    mb_b = dict((n, mb) for n, _, mb, _ in SNP_SAMPLES)["B"]
    bases = [mb * 1_000_000 // READ_LEN * READ_LEN for mb in (MBASES, mb_b)]
    args = [*YAK2_ARGS, path_a, path_b]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with recording_yak_engines() as made, timing_yak2() as times:
        t0 = time.perf_counter()
        got = run_tool("yak-count", args)
        wall = time.perf_counter() - t0
        insert_ms = sum(a.elapsed_time(b) for (a, b), _, _ in times["insert"])
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = made[0]
    need(f"-b{eng.bf_shift}" in YAK2_ARGS and not eng.plain_kernels,
         "the two-file engine is not on card compactors")
    need(times["insert"] and len(times["join_s"]) == 1,
         "pass 1 did not run the bloom admission, or the shrink no join")
    total = check_yak_text(got)
    n_b = bases[1] // READ_LEN
    need(sum(eng.batch_seq_counts) == n_b,
         f"pass 2 read {sum(eng.batch_seq_counts)} reads of {n_b}")
    n_lines = sum(ln.startswith("[M] ") for ln in got[1])
    need(n_lines > len(eng.batch_seq_counts) > 1,
         f"{n_lines} [M] lines, pass 2 in {len(eng.batch_seq_counts)} "
         "batches")
    first = got[1][0].split("; ")[1]
    say("yak2", f"yak-count {' '.join(YAK2_ARGS)} A ({MBASES} Mbases) "
        f"B ({mb_b} Mbases, genotype Y): {wall:.3f} s = "
        f"{sum(bases) / 1e6 / wall:.2f} Mbases/s over both files, "
        f"{total} distinct after shrinking, pass 1 {first}, peak device "
        f"memory {peak:.2f} GiB (bits array 2^{eng.bf_shift} bytes)")
    for i, st in enumerate(eng.stats, 1):
        say("yak2", f"pass {i} IngestStats: {stats_line(st)}")
    # bounds, bytes at HBM_BYTES_PER_S: the admission reads each key
    # (8 B) and its 64-byte bloom block and writes the admitted key (8
    # B); the join reads A's keys (8 B) and B's keys and counts (12 B)
    # and writes 1024 int64 bins
    ins_bytes = sum(n * 80 for _, n, _h in times["insert"])
    n1, n2 = times["join_lanes"]
    join_bytes = n1 * 8 + n2 * 12 + 1024 * 8
    say("yak2", f"bloom admission: {len(times['insert'])} calls over "
        f"{sum(n for _, n, _ in times['insert'])} lanes, {insert_ms:.3f} ms "
        f"of device time in all (CUDA events); bound {ins_bytes / 1e6:.0f} "
        f"MB = {ins_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    say("yak2", f"shrink join of {n1} + {n2} keys: "
        f"{times['join_s'][0] * 1e3:.3f} ms (host wall, synchronized); "
        f"bound {join_bytes / 1e6:.0f} MB = "
        f"{join_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    say("yak2", f"launches in this run: {json.dumps(launches)}")
    need(all(launches[name] > 0 for name in YAK2_KERNELS),
         f"a kernel of the two-file path was never launched: {launches}")
    need(not any(v for name, v in launches.items()
                 if name not in YAK2_KERNELS),
         f"the two-file path launched another kernel: {launches}")

    with recording_yak_engines(plain_kernels=True) as made:
        t0 = time.perf_counter()
        want = run_tool("yak-count", args)
        pwall = time.perf_counter() - t0
    need(made[0].plain_kernels, "the plain run did not use plain versions")
    need(got == want, "two-file yak-count with kernels != the plain "
         "versions on the card (stdout or [M lines)")
    say("yak2", f"plain versions on the card (both compactors, extract): "
        f"same stdout and [M lines, {pwall:.3f} s")
    return {"launches": launches, "got": got, "wall": wall}


EDVAF_SITES = 1000  # a small panel, as ed-vaf-counter's usage intends


@contextlib.contextmanager
def timing_myers():
    """Every myers_hw_sums{,_multiword} call of ed-vaf-counter, with a
    pair of CUDA events around it (no host synchronization): yields a
    list of (start event, end event, lane-step args); sums() after the
    run gives (device seconds, lane-steps, operations, ALU-only
    operations, bytes) of the calls, from myers_work."""
    import torch

    from kmer_tpu_torch.tools import ed_vaf_counter

    calls = []
    real = (ed_vaf_counter.myers_hw_sums,
            ed_vaf_counter.myers_hw_sums_multiword)

    def timed(fn, n_words_at):
        def call(peq, pat_len, codes, lens, max_e, *more):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(peq, pat_len, codes, lens, max_e, *more)
            b.record()
            n_words = more[0] if n_words_at else None
            calls.append((a, b, (pat_len, lens, codes.shape[1], n_words,
                                 peq.shape[-1])))
            return out
        return call

    ed_vaf_counter.myers_hw_sums = timed(real[0], False)
    ed_vaf_counter.myers_hw_sums_multiword = timed(real[1], True)
    try:
        yield calls
    finally:
        (ed_vaf_counter.myers_hw_sums,
         ed_vaf_counter.myers_hw_sums_multiword) = real


def myers_totals(calls):
    """(device s, lane-steps, operations, ALU-only operations, bytes) of
    timing_myers' calls, read after the run."""
    import torch

    torch.cuda.synchronize()
    secs = sum(a.elapsed_time(b) for a, b, _ in calls) / 1e3
    work = [myers_work(*w) for _a, _b, w in calls]
    return (secs, *(sum(w[i] for w in work) for i in range(4)))


@contextlib.contextmanager
def no_sync_in_batch_loop():
    """ed-vaf-counter's batch loop (tools/ed_vaf_counter.py: each batch's
    flush from `_Batches`; every upload and launch of the loop is inside
    one) under torch.cuda.set_sync_debug_mode("error"): a synchronizing
    call inside it (a .cpu(), .item(), a pageable copy, a stream or
    device synchronize) raises.  The staging buffers' event waits are
    cudaEventSynchronize, which the mode does not watch: _Staging.waits
    counts the ones that found the copy not done.  `native` counts the
    files read through the native reader."""
    import torch

    from kmer_tpu_torch.tools import ed_vaf_counter

    real_init = ed_vaf_counter._Batches.__init__
    real_records = ed_vaf_counter.native.iter_records_native
    stats = {"batches": 0, "native": 0}

    def init(self, lut, flush):
        def guarded(*a):
            stats["batches"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return flush(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        real_init(self, lut, guarded)

    def records(*a):
        stats["native"] += 1
        return real_records(*a)

    waits, real_upload = [], ed_vaf_counter._Staging.upload

    def upload(self, *a):
        out = real_upload(self, *a)
        waits.append(self.waits)
        return out

    ed_vaf_counter._Batches.__init__ = init
    ed_vaf_counter.native.iter_records_native = records
    ed_vaf_counter._Staging.upload = upload
    try:
        yield stats, waits
    finally:
        ed_vaf_counter._Batches.__init__ = real_init
        ed_vaf_counter.native.iter_records_native = real_records
        ed_vaf_counter._Staging.upload = real_upload


def read_file(path):
    with open(path, "rb") as f:
        return f.read()


def edvaf_inputs(seed):
    """(panel, head, sample B, its bases) under build/chip_smoke/edvaf/:
    the panel is the first EDVAF_SITES rows of phase 9's pattern file
    (snp-pattern-gen makes one there when phase 9 has not run), head is
    B's first EDVAF_READS reads as a plain FASTQ."""
    import gzip

    fasta, bed, fqs = snp_inputs(seed)
    mb_b = dict((n, mb) for n, _, mb, _ in SNP_SAMPLES)["B"]
    d = os.path.join(DATA_DIR, "edvaf")
    os.makedirs(d, exist_ok=True)
    src = os.path.join(DATA_DIR, "snp_card", "snps.pat")
    if not os.path.exists(src):
        src = os.path.join(d, "snps.pat")
        run_tool_err("snp-pattern-gen", [f"-k{SNP_K}", "-b", bed, "-f",
                                         fasta, "-o", src])
    with open(src) as f:
        rows = f.readlines()[:EDVAF_SITES]
    need(len(rows) == EDVAF_SITES, f"the snp panel has {len(rows)} rows")
    pat = os.path.join(d, f"panel_{EDVAF_SITES}.pat")
    with open(pat, "w") as f:
        f.writelines(rows)
    head = os.path.join(d, f"B_first_{EDVAF_READS}.fq")
    with gzip.open(fqs["B"], "rb") as f, open(head, "wb") as g:
        g.writelines(f.readline() for _ in range(4 * EDVAF_READS))
    return pat, head, fqs["B"], mb_b * 1_000_000 // READ_LEN * READ_LEN


def long_panel(d, head, seed):
    """A pattern file of LONG_SITES sites of phase 9's panel with k-mers
    of LONG_K bases (45 and 97, in turns), cut from phase 9's genome
    around each SNP in the pattern-file layout (snp-pattern-gen stops at
    -k 32): the sites whose k = 21 ref or alt k-mer occurs in `head` (B's
    first reads) first, so that the long patterns are found there, then
    the panel's next sites; each site's 21-mer must equal the genome's
    cut at its position."""
    import gzip

    fasta, _, _ = snp_inputs(seed)
    src = os.path.join(DATA_DIR, "snp_card", "snps.pat")
    if not os.path.exists(src):
        src = os.path.join(d, "snps.pat")
    with open(src) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    chroms, name = {}, None
    with gzip.open(fasta, "rt") as f:
        for line in f:
            if line.startswith(">"):
                name = line[1:].split()[0]
                chroms[name] = []
            else:
                chroms[name].append(line.strip())
    chroms = {c: "".join(parts) for c, parts in chroms.items()}
    with open(head) as f:
        reads = f.read().splitlines()[1::4]
    seen = {r[i:i + SNP_K] for r in reads for i in range(len(r) - SNP_K + 1)}
    hits = [r for r in rows if r[6] in seen or r[7] in seen]
    picked, out = set(), []
    for r in hits + rows:
        k = LONG_K[len(out) % len(LONG_K)]
        chrom, start, h = r[0], int(r[1]), k // 2
        seq = chroms[chrom]
        if r[3] in picked or start - h < 0 or start + h + 1 > len(seq):
            continue
        half = SNP_K // 2
        need(seq[start - half:start + half + 1] == r[6],
             f"long panel: {r[3]}'s 21-mer is not the genome's at {chrom}:"
             f"{start}")
        ref = seq[start - h:start + h + 1]
        alt = ref[:h] + r[5] + ref[h + 1:]
        out.append("\t".join([*r[:6], ref, alt]))
        picked.add(r[3])
        if len(out) == LONG_SITES:
            break
    need(len(out) == LONG_SITES, f"long panel: {len(out)} sites")
    path = os.path.join(d, f"panel_long_{LONG_SITES}.pat")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path, len(hits)


def edvaf_card_cpu(pat, head, out):
    """ed-vaf-counter -e1 on head with pattern file pat, on the card and
    on the CPU: (VAF bytes, wall s, launch counts) a platform."""
    from kmer_tpu_torch.kernels import _build

    res = {}
    for plat in ("cuda", "cpu"):
        with platform(plat):
            vaf = f"{out}_{plat}.vaf"
            _build.reset_launches()
            t0 = time.perf_counter()
            run_tool_err("ed-vaf-counter", ["-e1", "-p", pat, "-o", vaf,
                                            head])
            res[plat] = (read_file(vaf), time.perf_counter() - t0,
                         dict(_build.LAUNCHES))
    need(not any(res["cpu"][2].values()), "ed-vaf-counter on the CPU "
         f"launched a kernel: {res['cpu'][2]}")
    return res


def only(launches, want):
    """launches has exactly the counts of `want` and 0 elsewhere."""
    return all(launches[k] == want.get(k, 0) for k in launches)


def edvaf_run(pat, fq, out):
    """ed-vaf-counter -e1 on fq with pattern file pat on the card, its
    batch loop under no_sync_in_batch_loop and its Myers calls timed:
    a dict of the VAF lines, wall, launches, batches, event waits that
    blocked, Myers device seconds and work, and peak device memory: the
    process's, and the run's own (above what was allocated when it
    started; earlier phases may still hold tensors)."""
    import torch

    from kmer_tpu_torch.kernels import _build, myers

    counts_calls = []
    reals = (myers.myers_hw_counts_kernel,
             myers.myers_hw_counts_multiword_kernel)
    myers.myers_hw_counts_kernel = lambda *a: counts_calls.append(a)
    myers.myers_hw_counts_multiword_kernel = lambda *a: counts_calls.append(a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launches()
    try:
        with timing_myers() as calls, no_sync_in_batch_loop() as (stats,
                                                                    waits):
            t0 = time.perf_counter()
            run_tool_err("ed-vaf-counter", ["-e1", "-p", pat, "-o", out, fq])
            wall = time.perf_counter() - t0
    finally:
        (myers.myers_hw_counts_kernel,
         myers.myers_hw_counts_multiword_kernel) = reals
    launches = dict(_build.LAUNCHES)
    need(not counts_calls, "ed-vaf-counter called an (R, P) counts entry")
    myers_s, lane_steps, ops, alu, nbytes = myers_totals(calls)
    lines = read_file(out).decode().splitlines()
    return {"lines": lines, "wall": wall, "launches": launches,
            "batches": stats["batches"], "waits": waits[-1] if waits else 0,
            "native": stats["native"],
            "myers_s": myers_s, "work": (lane_steps, ops, alu, nbytes),
            "calls": len(calls),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "own_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}


def first_batch_sums(pat, head):
    """ed-vaf-counter's one-word sum call on head (B's first 2,048 reads,
    one batch) with pattern file pat: the kernel's totals and the plain
    version's on the same tensors on the card."""
    import torch

    from kmer_tpu_torch.kernels import myers
    from kmer_tpu_torch.tools import ed_vaf_counter

    got = []
    real = ed_vaf_counter.myers_hw_sums

    def grab(peq, pat_len, codes, lens, max_e, total):
        fresh = torch.zeros_like(total)
        got.append((real(peq, pat_len, codes, lens, max_e, fresh),
                    myers.myers_hw_sums_plain(peq, pat_len, codes, lens,
                                              max_e, torch.zeros_like(total)),
                    codes.shape))
        return real(peq, pat_len, codes, lens, max_e, total)

    ed_vaf_counter.myers_hw_sums = grab
    try:
        run_tool_err("ed-vaf-counter", ["-e1", "-p", pat, "-o",
                                        head + ".sums.vaf", head])
    finally:
        ed_vaf_counter.myers_hw_sums = real
    need(len(got) == 1, f"{len(got)} batches in B's first {EDVAF_READS} "
         "reads")
    return got[0]


def phase_edvaf(seed):
    pat, head, fq, bases = edvaf_inputs(seed)
    d = os.path.dirname(pat)
    # 1. the 1,000-site panel, the run the whole panel is held to
    small = edvaf_run(pat, fq, os.path.join(d, "B.vaf"))
    for run, sites in ((small, EDVAF_SITES),):
        need(run["batches"] > 0 and run["calls"] == run["batches"]
             and only(run["launches"], {"myers": run["batches"]}),
             f"ed-vaf-counter: not one myers launch a batch "
             f"({run['batches']} batches) and no other kernel: "
             f"{run['launches']}")
        need(len(run["lines"]) == sites + 2, f"{len(run['lines'])} VAF lines")
        need(run["native"] == 1, "ed-vaf-counter did not read sample B "
             "through the native reader")
    # 2. the whole 21,000-site panel (phase 9's pattern file)
    full_pat = os.path.join(os.path.dirname(d), "snp_card", "snps.pat")
    if not os.path.exists(full_pat):
        full_pat = os.path.join(d, "snps.pat")
    with open(full_pat) as f:
        n_full = sum(1 for _ in f)
    full = edvaf_run(full_pat, fq, os.path.join(d, "B_full.vaf"))
    need(full["batches"] == small["batches"] and full["calls"] ==
         full["batches"] and only(full["launches"],
                                  {"myers": full["batches"]}),
         f"ed-vaf-counter at {SNP_SITES} sites: not one myers launch a "
         f"batch ({full['batches']} batches): {full['launches']}")
    need(len(full["lines"]) == n_full + 2,
         f"{len(full['lines'])} VAF lines for {n_full} sites")
    need(full["lines"][1:EDVAF_SITES + 2] == small["lines"][1:],
         f"the {SNP_SITES}-site run's first {EDVAF_SITES} rows != the "
         f"{EDVAF_SITES}-site run's")
    for run, sites in ((small, EDVAF_SITES), (full, n_full)):
        depth = sum(int(ln.split("\t")[7]) for ln in run["lines"][2:])
        need(depth > 0, "ed-vaf-counter found no pattern in sample B")
        lane_steps, ops, alu, nbytes = run["work"]
        bound_s, by = myers_bound_s(ops, alu, nbytes,
                                    sm_clock_mhz() or 1980.0)
        say("edvaf", f"ed-vaf-counter -e1, {sites} sites ({2 * sites} "
            f"patterns, k={SNP_K}), sample B {bases / 1e6:.0f} Mbases: "
            f"{run['wall']:.3f} s = {bases / 1e6 / run['wall']:.2f} "
            f"Mbases/s; Myers {run['myers_s']:.3f} s of device time (CUDA "
            f"events around each call) in {run['batches']} batches "
            f"({100 * run['myers_s'] / run['wall']:.1f}% of the wall), "
            f"{run['launches']['myers']} myers launches (the sum entry) and "
            f"no other kernel; the batch loop made no synchronizing call, "
            f"{run['waits']} staging waits found a copy not done; peak "
            f"device memory {run['peak_gib']:.3f} GiB, the run's own "
            f"{run['own_gib']:.4f} GiB; {run['lines'][0]}, "
            f"total depth {depth}")
        say("edvaf", f"  Myers bound: {lane_steps} lane-steps, {ops} "
            f"operations ({alu} ALU-only): {bound_s:.4f} s by {by}")
    say("edvaf", f"the {SNP_SITES}-site run's first {EDVAF_SITES} rows "
        f"== the {EDVAF_SITES}-site run's")
    # 3. one batch of the full panel: kernel == plain on the card
    import torch

    ksum, psum, shape = first_batch_sums(full_pat, head)
    e = max_abs_err(ksum, psum)
    need(e == ERR_FREE, f"the first batch at {SNP_SITES} sites: kernel "
         f"sums != plain (max err {e})")
    say("edvaf", f"first batch at {SNP_SITES} sites ({shape[0]} reads x "
        f"{shape[1]} bases x {ksum.shape[0]} patterns): kernel sums == "
        f"plain sums, {int(ksum.sum())} end locations")
    del ksum, psum
    torch.cuda.empty_cache()
    # 4. card == CPU on B's first reads, 1,000 sites and the long panel
    res = edvaf_card_cpu(pat, head, os.path.join(d, f"B_first_{EDVAF_READS}"))
    need(res["cuda"][0] == res["cpu"][0],
         f"ed-vaf-counter on {EDVAF_READS} reads: card VAF != CPU VAF")
    need(only(res["cuda"][2], {"myers": 1}),
         f"ed-vaf-counter on one batch: {res['cuda'][2]}")
    say("edvaf", f"first {EDVAF_READS} reads (one batch): card VAF == CPU "
        f"VAF ({res['cuda'][1]:.3f} s on the card, one myers launch; "
        f"{res['cpu'][1]:.3f} s on the CPU)")
    lpat, n_hits = long_panel(d, head, seed)
    lres = edvaf_card_cpu(lpat, head,
                          os.path.join(d, f"B_first_{EDVAF_READS}_long"))
    need(lres["cuda"][0] == lres["cpu"][0],
         f"ed-vaf-counter, {LONG_K}-base panel: card VAF != CPU VAF")
    need(only(lres["cuda"][2], {"myers": 1, "myers_multiword": 1}),
         f"ed-vaf-counter, long panel: {lres['cuda'][2]}")
    llines = lres["cuda"][0].decode().splitlines()
    ldepth = sum(int(ln.split("\t")[7]) for ln in llines[2:])
    need(ldepth > 0, "ed-vaf-counter found no long pattern in B's head")
    say("edvaf", f"{LONG_SITES} sites at k = {LONG_K} ({n_hits} of phase "
        f"9's sites have a 21-mer in B's first {EDVAF_READS} reads): card "
        f"VAF == CPU VAF, total depth {ldepth}; myers_multiword launched "
        f"once ({lres['cuda'][1]:.3f} s on the card, {lres['cpu'][1]:.3f} s "
        "on the CPU)")
    return {"launches": full["launches"], "long_launches": lres["cuda"][2],
            "wall": full["wall"], "myers_s": full["myers_s"],
            "small_wall": small["wall"], "small_myers_s": small["myers_s"]}


# -- the host-only tools ---------------------------------------------------

_RANS_LOW = 1 << 23


def rans4x8_o0_encode(data: bytes) -> bytes:
    """A valid rANS 4x8 order-0 stream of data (htslib rANS_static.c
    layout: order byte, two u32 sizes, the frequency table, four u32
    states, the interleaved renormalization bytes), for the decoders."""
    import struct
    from collections import Counter

    n = len(data)
    counts = Counter(data)
    syms = sorted(counts)
    freq = {s: max(1, counts[s] * 4096 // n) for s in syms}
    top = max(syms, key=freq.get)
    freq[top] += 4096 - sum(freq.values())
    cum, c = {}, 0
    for s in syms:
        cum[s], c = c, c + freq[s]
    table = bytearray([syms[0]])
    for i, s in enumerate(syms):
        f = freq[s]
        table += bytes([f]) if f < 128 else bytes([0x80 | f >> 8, f & 255])
        nxt = syms[i + 1] if i + 1 < len(syms) else 0
        table += bytes([nxt, 0]) if nxt == s + 1 else bytes([nxt])
    main = n & ~3
    # the tail is read from the final states alone
    R = [_RANS_LOW + (cum[data[main + j]] if main + j < n else 0)
         for j in range(4)]
    out = bytearray()
    for i in range(main - 1, -1, -1):
        j, s = i & 3, data[i]
        x, f = R[j], freq[s]
        while x >= ((_RANS_LOW >> 12) << 8) * f:
            out.append(x & 255)
            x >>= 8
        R[j] = ((x // f) << 12) + x % f + cum[s]
    body = bytes(table) + struct.pack("<4I", *R) + bytes(reversed(out))
    return bytes([0]) + struct.pack("<II", len(body), n) + body


def run_with_stdin(tool, args, data: bytes):
    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(data))
    try:
        return run_tool_err(tool, args)[0]
    finally:
        sys.stdin = old


def phase_hosttools():
    """kc-py1, kc-cpp1, kc-cpp2, vcf-vaf-counter and bam-vaf-counter on
    the fixtures (host code: no kernel may launch).  The raw-string
    counters give kc-c1 -k31's histogram on the clean genome; the VCF,
    .vcf.gz and BCF forms of one sample give one VAF file; the
    sequential BAM scan runs natively and equals the Python reader; the
    native rANS decoder equals the Python one."""
    import gzip

    import numpy as np

    from kmer_tpu_torch.io import cram, native
    from kmer_tpu_torch.kernels import _build

    fix = os.path.join(HERE, "tests", "fixtures")
    d = os.path.join(DATA_DIR, "hosttools")
    os.makedirs(d, exist_ok=True)
    genome = os.path.join(fix, "genome_small.fa.gz")
    with gzip.open(genome, "rb") as f:
        raw = f.read()
    fasta = os.path.join(d, "genome_small.fa")
    with open(fasta, "wb") as f:
        f.write(raw)
    want = run_tool_err("kc-c1", ["-k31", genome])[0]
    _build.reset_launches()
    got = {"kc-py1": run_with_stdin("kc-py1", [], raw)}
    for tool in ("kc-cpp1", "kc-cpp2"):
        got[tool] = run_tool_err(tool, ["-k31", fasta])[0]
    for tool, text in got.items():
        need(text == want, f"{tool} on the genome != kc-c1 -k31")
    say("hosttools", f"kc-py1, kc-cpp1, kc-cpp2 on genome_small: == kc-c1 "
        f"-k31 on the card ({check_hist_text(want)} distinct)")

    pat = os.path.join(DATA_DIR, "fixture_snp_cpu", "snps.pat")
    vafs = {}
    for ext in ("vcf", "vcf.gz", "bcf"):
        out = os.path.join(d, f"sampleA.{ext}.vaf")
        run_tool_err("vcf-vaf-counter", ["-p", pat, "-v",
                                         os.path.join(fix, f"sampleA.{ext}"),
                                         "-o", out])
        vafs[ext] = read_file(out)
    need(len(set(vafs.values())) == 1, "vcf-vaf-counter: the VCF, .vcf.gz "
         "and BCF forms of sampleA give different VAF files")
    say("hosttools", f"vcf-vaf-counter on sampleA.vcf, .vcf.gz, .bcf: one "
        f"VAF file ({vafs['vcf'].splitlines()[0].decode()})")

    bam = os.path.join(d, "sampleA_aln_noidx.bam")
    with open(os.path.join(fix, "sampleA_aln.bam"), "rb") as f, \
            open(bam, "wb") as g:
        g.write(f.read())
    calls, real = [], native.bam_count_native

    def counted(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    native.bam_count_native = counted
    try:
        out = {}
        for how in ("native", "python"):
            vaf = os.path.join(d, f"sampleA_aln_{how}.vaf")
            t0 = time.perf_counter()
            if how == "python":
                with setenv("KMER_TPU_NO_NATIVE", "1"):
                    run_tool_err("bam-vaf-counter", ["-p", pat, "-o", vaf,
                                                     bam])
            else:
                run_tool_err("bam-vaf-counter", ["-p", pat, "-o", vaf, bam])
            out[how] = (read_file(vaf), time.perf_counter() - t0)
    finally:
        native.bam_count_native = real
    need(len(calls) == 2 and calls[0] is not None and calls[1] is None,
         "bam-vaf-counter on an unindexed BAM did not take the native scan "
         "(or the Python run did)")
    need(out["native"][0] == out["python"][0],
         "bam-vaf-counter: the native scan's VAF != the Python reader's")
    say("hosttools", f"bam-vaf-counter, unindexed BAM: native scan "
        f"({out['native'][1]:.3f} s) == Python reader "
        f"({out['python'][1]:.3f} s)")
    vaf = os.path.join(d, "sampleA_aln_bai.vaf")
    t0 = time.perf_counter()
    err = run_tool_err("bam-vaf-counter", ["-p", pat, "-o", vaf,
                                           os.path.join(fix,
                                                        "sampleA_aln.bam")])[1]
    need("Using indexed access" in err, "the .bai was not used")
    say("hosttools", f"bam-vaf-counter with its .bai: region queries, "
        f"{time.perf_counter() - t0:.3f} s "
        f"({read_file(vaf).splitlines()[0].decode()})")

    rng = np.random.default_rng(8)
    data = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), 1_000_003,
                            p=[0.3, 0.2, 0.2, 0.29, 0.01]))
    blob = rans4x8_o0_encode(data)
    t0 = time.perf_counter()
    nat = native.rans_decode_native(blob, len(data))
    t1 = time.perf_counter()
    py = cram._rans_decode_py(blob, len(data))
    t2 = time.perf_counter()
    need(nat is not None and nat == py == data,
         "rans_decode_native != the Python decoder (or != the input)")
    say("hosttools", f"rANS 4x8 order 0, {len(data)} bytes: native "
        f"({(t1 - t0) * 1e3:.1f} ms) == Python ({(t2 - t1) * 1e3:.1f} ms) == "
        "the input")
    need(not any(_build.LAUNCHES.values()), "a host tool launched a kernel")


KERNELS = [
    ("extract", "kmer_tpu_torch/csrc/extract.cu",
     "kmer_tpu/kernels/extract_tpu.py:111"),
    ("seghist", "kmer_tpu_torch/csrc/seghist.cu",
     "kmer_tpu/kernels/seghist.py:63"),
    ("merge_path", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:194"),
    ("merge_partition", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:103"),
    ("merge_path1", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:277"),
    ("merge_partition1", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:138"),
    ("merge_path3", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:232"),
    ("merge_partition3", "kmer_tpu_torch/csrc/merge.cu",
     "kmer_tpu/kernels/bitonic.py:121"),
    # not a Pallas kernel: the while_loop of count_table.resolve_slots
    ("resolve", "kmer_tpu_torch/csrc/table.cu",
     "kmer_tpu/table/count_table.py:74"),
    # not Pallas kernels: the lax.scans of myers_hw_counts{,_multiword}
    ("myers", "kmer_tpu_torch/csrc/myers.cu", "kmer_tpu/kernels/myers.py:50"),
    ("myers_multiword", "kmer_tpu_torch/csrc/myers.cu",
     "kmer_tpu/kernels/myers.py:134"),
]


# -- the mesh: logical shards of the one card ------------------------------

MESH_SHARDS = 4


def mesh_card():
    """The mesh's devices: MESH_SHARDS logical shards of card 0."""
    import torch

    return [torch.device("cuda", 0)] * MESH_SHARDS


@contextlib.contextmanager
def on_mesh(devices=None):
    """Run the tools on the mesh (KMER_TPU_FORCE_MESH=1); with devices,
    the mesh's default device list (dist.sharded.default_devices) is
    those."""
    from kmer_tpu_torch.dist import sharded

    real = sharded.default_devices
    if devices is not None:
        sharded.default_devices = lambda: list(devices)
    try:
        with setenv("KMER_TPU_FORCE_MESH", "1"):
            yield
    finally:
        sharded.default_devices = real


@contextlib.contextmanager
def recording_mesh_engines(tool_module, yak=False, plain_kernels=False):
    """Keep the mesh engines that a tool module's make_count_engine (with
    yak, yak-count's two-file make_yak_engine) builds; with plain_kernels,
    build them with the kernels' plain versions."""
    from kmer_tpu_torch.pipeline.counter import MeshSortCountEngine
    from kmer_tpu_torch.pipeline.yak import MeshSortYakEngine

    name, cls = (("make_yak_engine", MeshSortYakEngine) if yak
                 else ("make_count_engine", MeshSortCountEngine))
    made, real = [], getattr(tool_module, name)

    def record(*a, **kw):
        made.append(cls(*a, plain_kernels=True, **kw) if plain_kernels
                    else real(*a, **kw))
        return made[-1]

    setattr(tool_module, name, record)
    try:
        yield made
    finally:
        setattr(tool_module, name, real)


def on_card_shards(eng, phase):
    """Every shard of a mesh engine is on the card and holds kernels."""
    comps = eng.shards if hasattr(eng, "shards") else eng.eng.shards
    need(len(comps) == MESH_SHARDS and all(
        c.device.type == "cuda" for c in comps),
        f"[{phase}] the mesh is not {MESH_SHARDS} shards of the card: "
        f"{[str(c.device) for c in comps]}")


def mesh_route_ms(path, eng):
    """Routing + exchange of the first mesh step of path on the card:
    (device ms a step over a run of 5, lanes in, lanes out, byte bound
    ms).  The rows are extracted first, outside the timed region; the
    bound reads each key once (8 B) and writes each owned key once."""
    import torch

    from kmer_tpu_torch.dist import sharded
    from kmer_tpu_torch.kernels import extract
    from kmer_tpu_torch.pipeline import counter

    pin = eng.device.type == "cuda"
    steps = counter.mesh_steps([path], eng.k, eng.row_bases, eng.capacity,
                               ("resume", eng.k, 3), eng.n_dev, False, pin,
                               False, counter.IngestStats())
    rows, rb, *_ = next(steps)
    steps.close()
    keys = [counter.extract_row(r.to(dev), eng.k, rb, None, "ascii",
                                extract.extract_keys,
                                extract.extract_keys_rows)[0]
            for r, dev in zip(rows, eng.mesh.devices)]

    def route_exchange():
        # the engines' own routing (ShardedSortEngine.route_batch)
        return sharded.all_to_all(sharded.route_rows(keys, eng.n_dev),
                                  eng.mesh)

    owned = route_exchange()
    n_in = sum(int(k.shape[0]) for k in keys)
    n_out = sum(int(o.shape[0]) for o in owned)
    ms = time_run_ms(route_exchange)
    return ms, n_in, n_out, (n_in + n_out) * 8 / HBM_BYTES_PER_S * 1e3


def phase_mesh(seed, out):
    """The single-process mesh on MESH_SHARDS logical shards of the card:
    kc-c4 -k31 (256 Mbases), kc-c4 -k15 (32 Mbases, the 64 MiB budget
    split over the shards), two-file yak-count -k31 -b30 and vaf-counter
    A, each against the single-engine phase and the mesh with the plain
    kernel versions; a 1-shard mesh through the CLI gate; a checkpoint
    saved on the card mesh and resumed on a CPU mesh."""
    import numpy as np
    import torch

    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.pipeline.counter import (MeshSortCountEngine,
                                                 SortCountEngine)
    from kmer_tpu_torch.tools import kc, vaf_counter, yak_count

    card = mesh_card()
    path = reads_file(MBASES, seed)
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN

    # kc-c4 -k31 on 256 Mbases, through the tool
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with on_mesh(card), recording_mesh_engines(kc) as made:
        t0 = time.perf_counter()
        got = run_kc_c4([f"-k{K}", path])
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = made[0]
    need(isinstance(eng, MeshSortCountEngine), "kc-c4 did not count on "
         "the mesh")
    on_card_shards(eng, "mesh")
    need(eng.total_bases == bases, f"the mesh counted {eng.total_bases} "
         f"bases, the file has {bases}")
    need(got == out["e2e"]["out"], "kc-c4 on the mesh != phase 4's stdout")
    need(all(launches[n] > 0 for n in KC_PATH_KERNELS),
         f"a kernel of the kc-c4 path never launched on the mesh: "
         f"{launches}")
    e2e_wall = out["e2e"]["wall"]
    say("mesh", f"kc-c4 -k{K} {MBASES} Mbases on {MESH_SHARDS} shards of "
        f"the card: {wall:.3f} s = {bases / 1e6 / wall:.2f} Mbases/s "
        f"(phase 4, one engine: {e2e_wall:.3f} s = "
        f"{bases / 1e6 / e2e_wall:.2f} Mbases/s), same stdout, "
        f"{eng.total_kmers} k-mers, peak device memory {peak:.2f} GiB")
    say("mesh", f"IngestStats: {stats_line(eng.stats)}; finalize (hist) "
        f"{wall - eng.stats.loop_s:.3f} s; steps of {eng.n_dev} rows of "
        f"{eng.row_bases} bases")
    say("mesh", f"launches in this run (kc-c4 -k{K}): "
        f"{json.dumps(launches)}")
    # one engine reading the mesh's row-sized blocks: the share of the
    # wall that the block size, not the mesh, accounts for
    one = SortCountEngine(K, block_bases=eng.row_bases,
                          qual_policy=("resume", K, 3))
    t0 = time.perf_counter()
    one.count_paths([path])
    same = hist_text(one) == got
    owall = time.perf_counter() - t0
    need(same, "one engine at the mesh's block size != the mesh")
    say("mesh", f"one engine with {eng.row_bases}-base blocks: same "
        f"stdout, {owall:.3f} s = {bases / 1e6 / owall:.2f} Mbases/s "
        f"({stats_line(one.stats)})")
    del one
    ms, n_in, n_out, bound = mesh_route_ms(path, eng)
    say("mesh", f"routing + exchange of one step ({n_in} lanes in, {n_out} "
        f"owned keys out): {ms:.4f} ms of device time (CUDA events, a run "
        f"of 5); bound {(n_in + n_out) * 8 / 1e6:.1f} MB = {bound:.4f} ms "
        f"({100 * bound / ms:.1f}%)")
    del made, eng
    gc.collect()
    torch.cuda.empty_cache()
    with on_mesh(card), recording_mesh_engines(kc, plain_kernels=True) \
            as made:
        t0 = time.perf_counter()
        want = run_kc_c4([f"-k{K}", path])
        pwall = time.perf_counter() - t0
    need(made[0].plain_kernels and want == got,
         "kc-c4 on the mesh: kernels != the plain versions")
    say("mesh", f"plain versions on the mesh: same stdout, {pwall:.3f} s")
    del made
    gc.collect()

    # kc-c4 -k15 under the 64 MiB budget, a quarter of it a shard
    path15 = reads_file(32, seed + 1)
    texts = {}
    for plain_kernels in (False, True):
        _build.reset_launches()
        with on_mesh(card):
            e15 = MeshSortCountEngine(
                15, budget_bytes=(64 << 20) // MESH_SHARDS,
                qual_policy=("resume", 15, 3), plain_kernels=plain_kernels)
            on_card_shards(e15, "mesh")
            e15.count_paths([path15])
        trips = sum(bool(c.runs and c.runs[0][1] is not None)
                    for c in e15.eng.shards)
        texts[plain_kernels] = hist_text(e15)
        if not plain_kernels:
            l15 = dict(_build.LAUNCHES)
            need(trips > 0, "kc-c4 -k15 on the mesh: no shard's budget "
                 "tripped")
            need(all(l15[n] > 0 for n in ONE_PLANE_KERNELS)
                 and l15["seghist"] > 0,
                 f"kc-c4 -k15 on the mesh: the int32 merge path or seghist "
                 f"never launched: {l15}")
    need(texts[False] == out["onepl"]["out"] == texts[True],
         "kc-c4 -k15 on the mesh != phase 8, or != the plain versions")
    say("mesh", f"kc-c4 -k15 32 Mbases, {64 // MESH_SHARDS} MiB a shard: "
        f"== phase 8 == plain, budget tripped in {trips} of {MESH_SHARDS} "
        f"shards; launches {json.dumps(l15)}")
    del e15
    gc.collect()

    # two-file yak-count -k31 -b30, A then B (phase 10's files)
    path_b = snp_inputs(seed)[2]["B"]
    args = [*YAK2_ARGS, path, path_b]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with on_mesh(card), recording_mesh_engines(yak_count, yak=True) as made:
        t0 = time.perf_counter()
        ygot = run_tool("yak-count", args)
        ywall = time.perf_counter() - t0
    ylaunch = dict(_build.LAUNCHES)
    ypeak = torch.cuda.max_memory_allocated() / 2**30
    on_card_shards(made[0]._route, "mesh")
    need(made[0].use_bloom and made[0].spec.owner_bits == 2,
         "two-file yak-count on the mesh did not run the owner-partitioned "
         "bloom")
    need(ygot[0] == out["yak2"]["got"][0],
         "two-file yak-count on the mesh: stdout != phase 10's")
    need(all(ylaunch[n] > 0 for n in YAK_TAP_KERNELS + KC_PATH_KERNELS[:1]),
         f"two-file yak-count on the mesh: extract or the (key, index) "
         f"merge path never launched: {ylaunch}")
    n_lines = sum(ln.startswith("[M] ") for ln in ygot[1])
    mb_b = dict((n, mb) for n, _, mb, _ in SNP_SAMPLES)["B"]
    ybases = bases + mb_b * 1_000_000 // READ_LEN * READ_LEN
    say("mesh", f"yak-count {' '.join(YAK2_ARGS)} A B on the mesh: "
        f"{ywall:.3f} s = {ybases / 1e6 / ywall:.2f} Mbases/s (phase 10: "
        f"{out['yak2']['wall']:.3f} s), stdout == phase 10's, {n_lines} "
        f"[M] lines (the mesh's own steps), peak device memory "
        f"{ypeak:.2f} GiB")
    say("mesh", f"launches in this run (two-file yak-count): "
        f"{json.dumps(ylaunch)}")
    del made
    gc.collect()
    torch.cuda.empty_cache()
    with on_mesh(card), recording_mesh_engines(
            yak_count, yak=True, plain_kernels=True) as made:
        ywant = run_tool("yak-count", args)
    need(made[0].plain_kernels and ywant == ygot,
         "two-file yak-count on the mesh: kernels != the plain versions "
         "(stdout or [M lines)")
    say("mesh", "two-file yak-count, plain versions on the mesh: same "
        "stdout and [M lines")
    del made
    gc.collect()

    # vaf-counter -k21 on sample A against phase 9's panel
    fqs = snp_inputs(seed)[2]
    pat = os.path.join(DATA_DIR, "snp_card", "snps.pat")
    vaf_dir = os.path.join(DATA_DIR, "snp_mesh")
    os.makedirs(vaf_dir, exist_ok=True)
    vaf = os.path.join(vaf_dir, "A.vaf")
    with on_mesh(card), recording_mesh_engines(vaf_counter) as made:
        t0 = time.perf_counter()
        run_tool_err("vaf-counter", [f"-k{SNP_K}", "-p", pat, "-o", vaf,
                                     fqs["A"]])
        vwall = time.perf_counter() - t0
    on_card_shards(made[0], "mesh")
    need(read_file(vaf) == read_file(os.path.join(DATA_DIR, "snp_card",
                                                  "A.vaf")),
         "vaf-counter A on the mesh != phase 9's VAF file")
    say("mesh", f"vaf-counter -k{SNP_K} A on the mesh: VAF file == phase "
        f"9's, {vwall:.3f} s")
    del made
    gc.collect()

    # a 1-shard mesh through the CLI gate, on the default device list
    reads = os.path.join(HERE, "tests", "fixtures", "reads_small.fq.gz")
    with on_mesh(), recording_mesh_engines(kc) as made:
        one = run_kc_c4([f"-k{K}", reads])
    need(isinstance(made[0], MeshSortCountEngine) and made[0].n_dev == 1
         and made[0].device.type == "cuda",
         "KMER_TPU_FORCE_MESH=1 did not give a 1-shard mesh on the card")
    need(one == out["fixture"]["kc"]["reads_small.fq.gz", K],
         "the 1-shard mesh != phase 12's bytes")
    say("mesh", f"KMER_TPU_FORCE_MESH=1 on the default devices: a 1-shard "
        f"mesh on {made[0].device}, kc-c4 -k{K} == phase 12's bytes")

    # checkpoint: saved on the card mesh, resumed on a CPU mesh
    fix = os.path.join(HERE, "tests", "fixtures")
    a1, b = (os.path.join(fix, f"{n}.fq.gz") for n in ("sampleA1",
                                                        "sampleB"))
    ck = os.path.join(DATA_DIR, "mesh.ckpt.npz")
    e1 = MeshSortCountEngine(21, block_bases=1 << 17, devices=card)
    e1.count_paths([a1])
    e1.save_checkpoint(ck)
    e2 = MeshSortCountEngine(21, block_bases=1 << 17,
                             devices=["cpu"] * MESH_SHARDS)
    e2.resume_checkpoint_into(ck)
    e2.count_paths([b])
    full = MeshSortCountEngine(21, block_bases=1 << 17, devices=card)
    full.count_paths([a1, b])
    need(np.array_equal(e2.hist(256), full.hist(256))
         and e2._n_distinct == full._n_distinct
         and (e2.total_bases, e2.total_seqs, e2.total_kmers)
         == (full.total_bases, full.total_seqs, full.total_kmers),
         "a checkpoint saved on the card mesh and resumed on a CPU mesh "
         "!= an uninterrupted run")
    say("mesh", f"checkpoint: saved on the card mesh after sampleA1, "
        f"resumed on a {MESH_SHARDS}-shard CPU mesh for sampleB: hist == "
        f"an uninterrupted card run ({full._n_distinct} distinct)")
    return {"launches": launches, "yak2_launches": ylaunch,
            "yak2_lines": ygot[1]}


# -- phase 15: several processes ---------------------------------------------

MP_PROCS = 2  # processes on the one card, under gloo
MP_SHARDS = 2  # logical shards of the card a process: 4 global shards
PCIE_BYTES_PER_S = 64e9  # H100 SXM host link, PCIe Gen5 x16, a direction

# one worker process of a run of several: multihost.initialize with the
# rank, world size and port given, then the spec's items in order (every
# process runs the same items, so every collective lines up), each with
# its launch counts set to 0 just before it and read just after; writes
# result<rank>.json.  argv: rank, world size, port, spec file, out dir
MP_WORKER = r"""
import contextlib, io, json, os, sys, time
spec = json.load(open(sys.argv[4]))
sys.path.insert(0, spec["repo"])
import torch
from kmer_tpu_torch.dist import multihost, sharded
if spec["shards"]:
    sharded.default_devices = lambda: [torch.device("cuda", 0)] * spec["shards"]
pid, nproc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[5])
multihost.initialize("127.0.0.1:" + port, nproc, pid)
import torch.distributed as dist
from kmer_tpu_torch.kernels import _build
from kmer_tpu_torch.pipeline import counter
from kmer_tpu_torch.tools import get_tool, kc
from kmer_tpu_torch.utils import trace
from chip_smoke import stats_line
_build.library()
K = spec["k"]
POLICY = ("resume", K, 3)
# the tracer is on for every item, timed part included: each item's
# exchanges are its mesh.exchange spans
trace.enable(True)


def exchanges():
    # steps, host seconds and bytes of the mesh.exchange spans recorded
    # since the store was last emptied; empties it
    rec = [s for s in trace.spans() if s.name == "mesh.exchange"]
    trace.clear()
    return {"steps": len(rec), "s": sum(s.t1 - s.t0 for s in rec),
            "bytes": sum(s.attrs["bytes"] for s in rec)}


def barrier():
    torch.cuda.synchronize()
    sharded.allgather_ints([0])


def captured(fn, *a):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*a)
    assert rc in (0, None), (rc, err.getvalue()[-2000:])
    return out.getvalue(), [ln for ln in err.getvalue().splitlines()
                            if ln.startswith("[M")]


def hist_text(eng):
    return captured(kc._print_hist, eng.hist(256, max_count=None))[0]


def run(item):
    kind = item["kind"]
    if kind == "kc":  # the tool's counting path: make_count_engine
        h = kc._run_counter(item["paths"], K, 1023, qual_policy=POLICY)
        assert isinstance(h.eng, multihost.MultihostSortEngine), h.eng
        return {"out": hist_text(h.eng), "bases": h.eng.total_bases,
                "stats": stats_line(h.eng.stats)}
    if kind == "kc_plain":
        eng = multihost.MultihostSortEngine(K, qual_policy=POLICY,
                                            plain_kernels=True)
        eng.count_paths(item["paths"])
        return {"out": hist_text(eng)}
    if kind == "tool":
        os.environ.update(item.get("env", {}))
        args = [a.replace("{pid}", str(pid)) for a in item["args"]]
        out, lines = captured(get_tool(item["tool"]), args)
        for name in item.get("env", {}):
            del os.environ[name]
        return {"out": out, "lines": lines}
    if kind == "save":  # generation 1: count, save, and the run ends
        eng = multihost.MultihostSortEngine(K, qual_policy=POLICY)
        eng.count_paths(item["paths"])
        eng.save_checkpoint(item["ckpt"])
        return {"files": sorted(f for f in os.listdir(
            os.path.dirname(item["ckpt"])) if ".proc" in f)}
    if kind == "resume":
        eng = multihost.MultihostSortEngine(K, qual_policy=POLICY)
        eng.resume_checkpoint_into(item["ckpt"])
        eng.count_paths(item["paths"])
        return {"out": hist_text(eng), "bases": eng.total_bases}
    if kind == "exchange":  # one step's exchange, synchronized, 5 times
        eng = multihost.MultihostSortEngine(K, qual_policy=POLICY)
        batch = next(multihost._local_batches(
            multihost.shard_files(item["paths"]), K, eng.row_bases,
            eng.n_local, POLICY), None)  # None: this process has no file
        rows = torch.from_numpy(batch[0]) if batch else []
        rb = batch[3] if batch and batch[3] and batch[3] > K else None
        keys = [counter.extract_row(r.to(d), K, rb, None, "ascii",
                                    eng.eng._extract, eng.eng._extract_rows)[0]
                for r, d in zip(rows, eng.mesh.devices)]
        routed = sharded.route_rows(keys, eng.n_dev)
        times = []
        for _ in range(6):
            barrier()
            trace.clear()
            t0 = time.perf_counter()
            sharded.all_to_all(routed, eng.mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return {"ms": sum(times[1:]) / 5 * 1e3,
                "bytes": exchanges()["bytes"],
                "lanes": sum(int(k.shape[0]) for k in keys),
                "row_bases": eng.row_bases}
    raise ValueError(kind)


results = []
for item in spec["items"]:
    barrier()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    trace.clear()
    t0 = time.perf_counter()
    r = run(item)
    torch.cuda.synchronize()
    r["wall"] = time.perf_counter() - t0
    r["launches"] = dict(_build.LAUNCHES)
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["exchange"] = exchanges()
    r["name"] = item["name"]
    results.append(r)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kmer_tpu"))
assert not bad, bad
with open(os.path.join(out_dir, f"result{pid}.json"), "w") as f:
    json.dump({"backend": dist.get_backend(), "results": results,
               "device": str(torch.cuda.current_device())}, f)
dist.destroy_process_group()
"""


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_multiproc(name, items, n_proc=MP_PROCS, shards=MP_SHARDS,
                  timeout=900):
    """Start n_proc workers (MP_WORKER) on a free port, each with shards
    logical shards of card 0 (shards=0: the process's own card, one
    process a card), and wait for them; a worker that does not end in
    time is killed, and any exit code but 0 fails the phase.  Returns
    each process's result dict, by rank."""
    d = os.path.join(DATA_DIR, "multiproc", name)
    os.makedirs(d, exist_ok=True)
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump({"repo": HERE, "k": K, "shards": shards,
                   "items": items}, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KMER_TPU_")}
    if shards:  # every process on card 0, under gloo
        env["CUDA_VISIBLE_DEVICES"] = "0"
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_WORKER, str(pid), str(n_proc), port, spec,
         d], env={**env, "LOCAL_RANK": str(pid)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n_proc)]
    outs = [None] * n_proc
    try:
        deadline = time.monotonic() + timeout
        for i, p in enumerate(procs):
            outs[i] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        need(out is not None and p.returncode == 0,
             f"[multiproc] {name}: worker {pid} exited {p.returncode}: "
             f"{(out or ('', ''))[1][-3000:]}")
    res = []
    for pid in range(n_proc):
        with open(os.path.join(d, f"result{pid}.json")) as f:
            res.append(json.load(f))
    return res


def mp_line(r, bases=None):
    """wall, Mbases/s, peak memory and exchange time a step of an item,
    run with the port's tracer on (its exchanges are its mesh.exchange
    spans)."""
    x = r["exchange"]
    rate = f" = {bases / 1e6 / r['wall']:.2f} Mbases/s" if bases else ""
    return (f"{r['wall']:.3f} s{rate}, peak device memory "
            f"{r['peak_gib']:.2f} GiB, {x['steps']} exchanges "
            f"({x['s'] / max(x['steps'], 1) * 1e3:.2f} ms of host wall a "
            f"step, {x['bytes'] / 1e6:.0f} MB sent + received; tracer "
            f"on)")


def phase_multiproc(seed, out):
    """Runs of two processes, each with two logical shards of the card
    (four global shards, gloo): kc-c4 -k31 over two 256 Mbase files ==
    one engine over both (kernels and plain versions), two-file
    yak-count == phase 10, vaf-counter A == phase 9 (process 0's file
    alone), single-reader two-file yak-count == phase 10's stdout and
    phase 14's `[M` lines, a checkpoint kill-and-resume; on a machine of
    several cards, one process a card under NCCL."""
    import torch

    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    path = reads_file(MBASES, seed)
    t0 = time.perf_counter()
    path2 = reads_file(MBASES, seed + 100)
    say("multiproc", f"second file {os.path.relpath(path2, HERE)} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    path_b = snp_inputs(seed)[2]["B"]
    fqs = snp_inputs(seed)[2]
    pat = os.path.join(DATA_DIR, "snp_card", "snps.pat")
    vaf_dir = os.path.join(DATA_DIR, "multiproc", "vaf")
    for pid in range(MP_PROCS):
        vaf = os.path.join(vaf_dir, f"p{pid}", "A.vaf")
        os.makedirs(os.path.dirname(vaf), exist_ok=True)
        if os.path.exists(vaf):
            os.remove(vaf)
    ck_dir = os.path.join(DATA_DIR, "multiproc", "ckpt")
    os.makedirs(ck_dir, exist_ok=True)
    for f in os.listdir(ck_dir):
        os.remove(os.path.join(ck_dir, f))
    ckpt = os.path.join(ck_dir, "state.ckpt")
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN

    one = SortCountEngine(K, qual_policy=("resume", K, 3))
    t0 = time.perf_counter()
    one.count_paths([path, path2])
    want = hist_text(one)
    owall = time.perf_counter() - t0
    need(one.total_bases == 2 * bases, "one engine missed bases")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    yak_args = [*YAK2_ARGS, path, path_b]
    items = [
        {"name": "kc", "kind": "kc", "paths": [path, path2]},
        {"name": "exchange", "kind": "exchange", "paths": [path, path2]},
        {"name": "kc_plain", "kind": "kc_plain", "paths": [path, path2]},
        {"name": "yak2", "kind": "tool", "tool": "yak-count",
         "args": yak_args},
        {"name": "vaf", "kind": "tool", "tool": "vaf-counter",
         "args": [f"-k{SNP_K}", "-p", pat, "-o",
                  os.path.join(vaf_dir, "p{pid}", "A.vaf"), fqs["A"]]},
        {"name": "yak2_sr", "kind": "tool", "tool": "yak-count",
         "args": yak_args, "env": {"KMER_TPU_SINGLE_READER": "1"}},
        {"name": "save", "kind": "save", "paths": [path], "ckpt": ckpt},
    ]
    t0 = time.perf_counter()
    gen1 = run_multiproc("gen1", items)
    jwall = time.perf_counter() - t0
    by = [{r["name"]: r for r in res["results"]} for res in gen1]
    need(all(res["backend"] == "gloo" for res in gen1),
         f"two processes on one card did not take gloo: "
         f"{[res['backend'] for res in gen1]}")
    p0, p1 = by

    # 1. kc-c4 -k31 over both files, one a process
    need(p0["kc"]["out"] == want, "kc-c4 on two processes != one engine "
         "over both files")
    need(p1["kc"]["out"] == "", "process 1 printed a histogram")
    need(p0["kc"]["bases"] == 2 * bases, "the processes missed bases")
    for pid, p in enumerate(by):
        la = p["kc"]["launches"]
        need(all(la[n] > 0 for n in KC_PATH_KERNELS),
             f"kc-c4 on process {pid}: a kernel never launched: {la}")
    say("multiproc", f"kc-c4 -k{K} A + A' ({2 * MBASES} Mbases), "
        f"{MP_PROCS} processes x {MP_SHARDS} shards of the card (gloo): "
        f"process 0 == one engine over both ({owall:.3f} s = "
        f"{2 * bases / 1e6 / owall:.2f} Mbases/s), process 1 prints "
        f"nothing; phase 4 (one engine, A): {out['e2e']['wall']:.3f} s")
    for pid, p in enumerate(by):
        say("multiproc", f"  process {pid}: {mp_line(p['kc'], 2 * bases)}; "
            f"{p['kc']['stats']}")
        say("multiproc", f"  process {pid} launches: "
            f"{json.dumps(p['kc']['launches'])}")
    # the exchange of one step, synchronized (D2H, gloo, H2D)
    for pid, p in enumerate(by):
        x = p["exchange"]
        bound = x["bytes"] / PCIE_BYTES_PER_S * 1e3
        say("multiproc", f"  process {pid}: one step's exchange ({x['lanes']} "
            f"lanes in, rows of {x['row_bases']} bases): {x['ms']:.3f} ms "
            f"(host wall, synchronized, mean of 5); {x['bytes'] / 1e6:.1f} "
            f"MB across PCIe (D2H + H2D) = {bound:.3f} ms at 64 GB/s "
            f"({100 * bound / x['ms']:.1f}%)")
    # 2. plain versions
    need(p0["kc_plain"]["out"] == want and p1["kc_plain"]["out"] == "",
         "kc-c4 on two processes: kernels != the plain versions")
    need(not any(v for p in by for v in p["kc_plain"]["launches"].values()),
         "the plain run launched a kernel")
    say("multiproc", f"plain versions: same stdout, "
        f"{p0['kc_plain']['wall']:.3f} s")
    # 3. two-file yak-count
    need(p0["yak2"]["out"] == out["yak2"]["got"][0],
         "two-file yak-count on two processes != phase 10's stdout")
    need(p1["yak2"]["out"] == "", "process 1 printed yak-count rows")
    # each pass reads one file, so process 0 reads (and extracts) both;
    # every process merges its shards' (key, index) lanes
    for pid, p in enumerate(by):
        la = p["yak2"]["launches"]
        need((la["extract"] > 0 or pid) and all(la[n] > 0
                                                for n in YAK_TAP_KERNELS),
             f"two-file yak-count on process {pid}: extract or the (key, "
             f"index) merge path never launched: {la}")
        la = p["yak2_sr"]["launches"]
        need(la["extract"] > 0 and all(la[n] > 0 for n in YAK_TAP_KERNELS),
             f"single-reader yak-count on process {pid}: extract or the "
             f"(key, index) merge path never launched: {la}")
    mb_b = dict((n, mb) for n, _, mb, _ in SNP_SAMPLES)["B"]
    ybases = bases + mb_b * 1_000_000 // READ_LEN * READ_LEN
    say("multiproc", f"yak-count {' '.join(YAK2_ARGS)} A B: process 0 == "
        f"phase 10's stdout ({out['yak2']['wall']:.3f} s), "
        f"{len(p0['yak2']['lines'])} [M lines")
    for pid, p in enumerate(by):
        say("multiproc", f"  process {pid}: {mp_line(p['yak2'], ybases)}; "
            f"launches {json.dumps(p['yak2']['launches'])}")
    # 4. vaf-counter A
    need(read_file(os.path.join(vaf_dir, "p0", "A.vaf")) == read_file(
        os.path.join(DATA_DIR, "snp_card", "A.vaf")),
        "vaf-counter A on two processes != phase 9's VAF file")
    need(not os.path.exists(os.path.join(vaf_dir, "p1", "A.vaf")),
         "process 1 wrote a VAF file")
    say("multiproc", f"vaf-counter -k{SNP_K} A: process 0's file == phase "
        f"9's, process 1 wrote none; {mp_line(p0['vaf'], bases)}")
    # 5. single reader
    need(p0["yak2_sr"]["out"] == out["yak2"]["got"][0],
         "single-reader yak-count != phase 10's stdout")
    need(p0["yak2_sr"]["lines"] == out["mesh"]["yak2_lines"],
         "single-reader yak-count's [M lines != phase 14's 4-shard mesh")
    say("multiproc", f"KMER_TPU_SINGLE_READER=1 yak-count A B: stdout == "
        f"phase 10's, {len(p0['yak2_sr']['lines'])} [M lines == phase "
        f"14's 4-shard mesh; {mp_line(p0['yak2_sr'], ybases)}")
    # 6. checkpoint: generation 1 saved after A and ended; a new one
    # resumes on a new port and counts A'
    need(p0["save"]["files"] == ["state.ckpt.proc0of2.npz",
                                 "state.ckpt.proc1of2.npz"],
         f"generation 1 wrote {p0['save']['files']}")
    gen2 = run_multiproc("gen2", [{"name": "resume", "kind": "resume",
                                   "paths": [path2], "ckpt": ckpt}])
    r0 = gen2[0]["results"][0]
    need(r0["out"] == want and r0["bases"] == 2 * bases
         and gen2[1]["results"][0]["out"] == "",
         "a checkpoint kill-and-resume != one engine over both files")
    say("multiproc", f"checkpoint: generation 1 counted A and saved "
        f"{p0['save']['wall']:.3f} s, a new generation resumed and counted "
        f"A' ({r0['wall']:.3f} s): hist == one engine over both")
    say("multiproc", f"first generation's workers: {jwall:.1f} s of wall")

    if torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        t0 = time.perf_counter()
        res = run_multiproc("nccl", items[:1] + items[3:4], n_proc=n,
                            shards=0)
        need(all(r["backend"] == "nccl" for r in res),
             "one process a card did not take NCCL")
        q = [{r["name"]: r for r in x["results"]} for x in res]
        need(q[0]["kc"]["out"] == want and q[0]["yak2"]["out"]
             == out["yak2"]["got"][0]
             and not any(x["kc"]["out"] or x["yak2"]["out"] for x in q[1:]),
             f"{n} processes under NCCL != one engine / phase 10")
        say("multiproc", f"{n} processes, one card each (NCCL): kc-c4 == one "
            f"engine, yak-count == phase 10; {time.perf_counter() - t0:.1f} s")
        for pid, x in enumerate(q):
            say("multiproc", f"  process {pid} on cuda:{res[pid]['device']}: "
                f"kc-c4 {mp_line(x['kc'], 2 * bases)}; yak-count "
                f"{mp_line(x['yak2'], ybases)}")
    else:
        say("multiproc", "one card: only the gloo form ran (NCCL needs a "
            "card a process)")
    return {"kc": p0["kc"], "yak2": p0["yak2"]}


# -- phase 16: the open-addressing table engines (KMER_TPU_TABLE_YAK=1) -----

# the table path runs extract and the slot resolve, and no merge and no
# segment histogram: that is what shows KMER_TPU_TABLE_YAK=1 switched
TABLE_KERNELS = ("extract", "resolve", "bloom")
SECTOR_BYTES = 32  # a random access moves one 32-byte sector


@contextlib.contextmanager
def recording_resolves():
    """Record each resolve kernel call's (rounds, probes, lanes)."""
    from kmer_tpu_torch.kernels import table as kt

    calls, real = [], kt.resolve_slots_kernel

    def record(state, tkey, keys, valid, create_new):
        r = real(state, tkey, keys, valid, create_new)
        calls.append((r.rounds, r.probes, keys.shape[0]))
        return r

    kt.resolve_slots_kernel = record
    try:
        yield calls
    finally:
        kt.resolve_slots_kernel = real


@contextlib.contextmanager
def recording_table_engines():
    """Keep the engines that yak-count's two-file branch builds."""
    from kmer_tpu_torch.tools import yak_count

    made, real = [], yak_count.make_yak_engine

    def record(**kw):
        made.append(real(**kw))
        return made[-1]

    yak_count.make_yak_engine = record
    try:
        yield made
    finally:
        yak_count.make_yak_engine = real


def first_blocks(path, n):
    """The first n extracted 10 Mbase blocks of path on the card (key
    planes, as the engines' reader and the extract kernel give them)."""
    import torch

    from kmer_tpu_torch.kernels import extract
    from kmer_tpu_torch.pipeline import counter

    chunk = 10_000_000
    it = counter._extracted_blocks(
        [path], K, chunk, chunk + max(4096, chunk // 32), ("resume", K, 3),
        torch.device("cuda"), False, extract.extract_keys,
        extract.extract_keys_rows, counter.IngestStats())
    out = [next(it)[0] for _ in range(n)]
    it.close()
    return out


def resolve_bytes(r, m, cap):
    """The least bytes of one resolve: the keys (8 B) and valid flags in,
    slot (8 B) and found out a lane, created out a slot, and for each
    probe of each round the random sectors of its state byte and of its
    key (the data decides the probes: this call's count)."""
    return m * (8 + 1 + 8 + 1) + cap + r.probes * 2 * SECTOR_BYTES


def resolve_case(label, table, keys, create_new, floor_ms):
    """The resolve kernel against its plain version on copies of one
    table's planes, timed in turns (CUDA events, setup outside);
    (max_abs_err, kernel ms, plain ms, bytes, Resolved)."""
    import torch

    from kmer_tpu_torch.kernels import table as kt
    from kmer_tpu_torch.kernels.keys import SENT

    valid = keys != SENT
    st0, k0 = table.state, table.key
    a = (st0.clone(), k0.clone())
    b = (st0.clone(), k0.clone())
    got, syncs = host_syncs(
        lambda: kt.resolve_slots_kernel(*a, keys, valid, create_new))
    need(syncs == 1, f"[table] resolve {label}: {syncs} host "
         f"synchronizations in one call, not 1")
    want = kt.resolve_slots_plain(*b, keys, valid, create_new)
    err = max(max_abs_err(x, y) for x, y in (
        (a[0], b[0]), (a[1], b[1]), (got.slot, want.slot),
        (got.found, want.found), (got.created, want.created)))
    need(err == ERR_FREE and (got.rounds, got.probes)
         == (want.rounds, want.probes),
         f"[table] resolve {label}: kernel != plain (max err {err}, "
         f"rounds {got.rounds} / {want.rounds})")
    del a, b, want

    def setup():
        return st0.clone(), k0.clone()

    ms, plain_ms = [], []
    for turn in ("kernel", "plain", "plain", "kernel"):
        fn = (kt.resolve_slots_kernel if turn == "kernel"
              else kt.resolve_slots_plain)
        (ms if turn == "kernel" else plain_ms).append(time_ms(
            lambda p: fn(*p, keys, valid, create_new), setup, reps=3))
    ms, plain_ms = sum(ms) / 2, sum(plain_ms) / 2
    m, cap = keys.shape[0], table.capacity
    nbytes = resolve_bytes(got, m, cap)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    say("table", f"resolve {label}: {m} lanes ({int(valid.sum())} valid) "
        f"into {cap} slots ({int(table.n_full)} FULL before), create_new "
        f"{create_new}: kernel == plain; {got.rounds} rounds, {got.probes} "
        f"probe-lanes ({got.probes / max(int(valid.sum()), 1):.3f} a lane); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{nbytes / 1e6:.1f} MB = {bound:.4f} ms ({100 * bound / ms:.1f}%); "
        f"one launch and one host synchronization; {got.rounds} rounds x "
        f"the tail's floor {floor_ms:.4f} ms = {got.rounds * floor_ms:.4f} "
        f"ms")
    return err, ms, plain_ms, nbytes, got


def host_syncs(fn):
    """(fn(), the host synchronizations it made), counted by
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(w.message) for w in seen)


def round_floor_ms(dev, lanes, chain=256):
    """One in-kernel round's floor over `lanes` lanes of one key (1: the
    one-block tail; more than the tail's lanes: the grid, two grid
    barriers a round): a lookup whose probe chain is `chain` slots long
    (FULL with another key, then EMPTY) takes chain + 1 rounds, a lookup
    at an EMPTY slot one; the floor is the difference over chain, each
    timed as a run of 20 calls."""
    import torch

    from kmer_tpu_torch.kernels import table as kt
    from kmer_tpu_torch.kernels.hash64 import slot_mix32
    from kmer_tpu_torch.table import count_table as ct

    cap = 1 << 16
    keys = torch.full((lanes,), 12345, dtype=torch.int64, device=dev)
    ok = torch.ones(lanes, dtype=torch.bool, device=dev)
    empty, walk = ct.make(cap, dev), ct.make(cap, dev)
    base = int(slot_mix32(keys[:1])) & (cap - 1)
    run = (base + torch.arange(chain, device=dev)) & (cap - 1)
    walk.state[run] = ct.FULL
    walk.key[run] = 54321
    ms = [time_run_ms(lambda t=t: kt.resolve_slots_kernel(
        t.state, t.key, keys, ok, False), reps=20) for t in (empty, walk)]
    r = kt.resolve_slots_kernel(walk.state, walk.key, keys, ok, False)
    need(r.rounds == chain + 1, f"the floor's chain took {r.rounds} rounds")
    return (ms[1] - ms[0]) / chain


def ptxas_lines(src, symbol):
    """nvcc's `-Xptxas -v` report (registers, spills, shared memory) of
    the kernels of `src` whose mangled name holds `symbol`, compiled
    with the library's flags."""
    from kmer_tpu_torch.kernels import _build

    obj = os.path.join(_build.BUILD_DIR, "ptxas_report.o")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-c", "-o", obj, src], capture_output=True,
                       text=True, timeout=300)
    need(r.returncode == 0, f"nvcc -Xptxas -v {src} failed: {r.stderr}")
    os.remove(obj)
    out, mine = [], False
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = symbol in line
        elif mine and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def plain_parts(table, slot, contrib, keys):
    """The table's plain-torch device parts at the path's shapes, timed
    as a run of 5 calls (CUDA events), each with its byte bound: the
    count delta (index_add_ on int64, & 0xFFFFFFFF, the min), the first
    lane a slot (scatter_reduce amin) and hist (one bincount)."""
    import torch

    from kmer_tpu_torch.table import count_table as ct

    cap, m = table.capacity, keys.shape[0]
    lane = torch.arange(m, device=keys.device)

    def delta():
        return ct._add_counts(table, ct._slot_delta(cap, slot, contrib), 1023)

    def first():
        f = torch.full((cap + 1,), m, dtype=torch.int64, device=keys.device)
        return f.scatter_reduce_(0, slot, lane, "amin")[slot] == lane

    parts = {
        # slot and flag in, cnt read and written
        "count delta": (delta, m * 9 + cap * 8),
        # slot in, the first-lane plane and a flag a lane out
        "first lane": (first, m * 8 + (cap + 1) * 8 + m),
        # state and cnt in, 1024 bins out
        "hist": (lambda: ct.hist(table, 1024), cap * 5 + 1024 * 8),
    }
    rows = {}
    for name, (fn, nbytes) in parts.items():
        ms = time_run_ms(fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = (ms, bound)
        say("table", f"{name} (plain torch), {m} lanes over {cap} slots: "
            f"{ms:.4f} ms; bound {nbytes / 1e6:.1f} MB = {bound:.4f} ms "
            f"({100 * bound / ms:.1f}%)")
    return rows


def yak_rows_text(h):
    return "\n".join(f"{i}\t{h[i]}" for i in range(1, len(h))) + "\n"


def phase_table(seed, out):
    """The open-addressing table engines: the resolve kernel against its
    plain version on the first three 10 Mbase blocks of A (a fresh
    table; a table near GROW_LOAD holding tombstones, through
    insert_gated; lookups), `KMER_TPU_TABLE_YAK=1 yak-count -k31 -b30 A
    B` through the tool (== phase 10's stdout and `[M` lines; extract
    and resolve launch, no merge and no seghist), a YakEngine checkpoint
    saved after pass 1 and resumed on the card (== phase 10's stdout),
    and the table engine on phase 14's 4 shards of the card and in phase
    15's two processes (== phase 10's stdout)."""
    import torch

    from kmer_tpu_torch.kernels import _build, bloom
    from kmer_tpu_torch.kernels import table as kt
    from kmer_tpu_torch.kernels.keys import SENT
    from kmer_tpu_torch.pipeline import yak
    from kmer_tpu_torch.pipeline.counter import GROW_LOAD
    from kmer_tpu_torch.table import count_table as ct

    dev = torch.device("cuda")
    path_a = reads_file(MBASES, seed)
    path_b = snp_inputs(seed)[2]["B"]
    args = [*YAK2_ARGS, path_a, path_b]
    blocks = first_blocks(path_a, 3)
    shape = kt.kernel_shape(dev)
    regs = ptxas_lines(os.path.join(_build.CSRC, "table.cu"), "resolve")
    need(regs, "no -Xptxas -v report of the resolve kernel")
    say("table", f"resolve: a cooperative grid of {shape['blocks']} blocks "
        f"({shape['blocks_per_sm']} a SM x {shape['sms']} SMs) of "
        f"{shape['threads']} threads, {shape['registers']} registers a "
        f"thread, the one-block tail from {shape['tail_lanes']} lanes; "
        f"-Xptxas -v: {'; '.join(regs)}")
    floor = round_floor_ms(dev, 1)
    grid_floor = round_floor_ms(dev, 4 * shape["tail_lanes"])
    say("table", f"one in-kernel round's floor: {floor:.5f} ms in the "
        f"one-block tail (one lane), {grid_floor:.5f} ms on the grid "
        f"({4 * shape['tail_lanes']} lanes of one key)")

    # 1. a fresh table sized for block 1, as YakEngine._maybe_grow sizes it
    n1 = int((blocks[0] != SENT).sum())
    cap = 1 << 20
    while n1 > GROW_LOAD * cap:
        cap *= 2
    err, ms, plain_ms, nbytes, r = resolve_case(
        "block 1, fresh table", ct.make(cap, dev), blocks[0], True, floor)
    row = {**kernel_row(err, ms, plain_ms, nbytes), "rounds": r.rounds,
           "probes": r.probes}
    # 2. blocks 1-2 bloom-gated into 2^25 slots, as the engine inserts
    # them but with no rebuild, so their tombstones stay: block 3's worst
    # case then lies past GROW_LOAD, and still fits
    spec = bloom.BloomSpec(10, 30, 4)
    bits = bloom.make_bits(spec, dev)
    t = ct.make(1 << 25, dev)
    for keys in blocks[:2]:
        v = keys != SENT
        bits, preset = bloom.insert_sequential(bits, keys, v, spec)
        t, _n, _d = ct.insert_gated(t, keys, v, preset, yak.YAK_MAX_COUNT)
    n_dead = int((t.state == ct.DELETED).sum())
    n3 = int((blocks[2] != SENT).sum())
    say("table", f"before block 3: {int(t.n_full)} FULL, {n_dead} DELETED "
        f"in {t.capacity} slots ({(int(t.n_full) + n_dead) / t.capacity:.3f}"
        f"); with block 3's {n3} lanes at worst "
        f"{(int(t.n_full) + n_dead + n3) / t.capacity:.3f} (GROW_LOAD "
        f"{GROW_LOAD})")
    e2, ms2, pms2, nb2, _r2 = resolve_case(
        "block 3, near GROW_LOAD with tombstones", t, blocks[2], True, floor)
    valid3 = blocks[2] != SENT
    bits, preset = bloom.insert_sequential(bits, blocks[2], valid3, spec)
    res = []
    for plain in (False, True):
        c = ct.CountTable(t.state.clone(), t.key.clone(), t.cnt.clone(),
                          t.n_full.clone())
        c, n_new, n_dead = ct.insert_gated(c, blocks[2], valid3, preset,
                                           yak.YAK_MAX_COUNT, plain)
        res.append((c, int(n_new), int(n_dead)))
    (ck, nk, dk), (cp, np_, dp) = res
    e_g = max(max_abs_err(x, y) for x, y in zip(ck[:3], cp[:3]))
    need(e_g == ERR_FREE and (nk, dk) == (np_, dp),
         f"[table] insert_gated on block 3: kernel != plain (err {e_g})")
    say("table", f"insert_gated block 3: planes (state, key, cnt) kernel == "
        f"plain; {nk} new keys, {dk} rolled back to DELETED")
    # 3. lookups: block 1 against the table after block 3
    e3, ms3, pms3, nb3, _r3 = resolve_case(
        "lookups of block 1 after block 3", ck, blocks[0], False, floor)
    row["max_abs_err"] = max(err, e2, e_g, e3)
    slot = ct.resolve_slots(
        ct.CountTable(t.state.clone(), t.key.clone(), t.cnt, t.n_full),
        blocks[2], valid3, True).slot
    parts = plain_parts(ck, slot, valid3 & preset, blocks[2])
    del t, ck, cp, res, slot, preset, bits, blocks
    gc.collect()
    torch.cuda.empty_cache()

    # 4. KMER_TPU_TABLE_YAK=1 yak-count -k31 -b30 A B through the tool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with setenv("KMER_TPU_TABLE_YAK", "1"), recording_table_engines() as \
            made, recording_resolves() as calls:
        t0 = time.perf_counter()
        got = run_tool("yak-count", args)
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = made[0]
    need(type(eng) is yak.YakEngine and eng.device.type == "cuda"
         and not eng.plain_kernels,
         f"KMER_TPU_TABLE_YAK=1 did not run YakEngine on the card: {eng!r}")
    need(got == out["yak2"]["got"],
         "the table engine's yak-count != phase 10's (stdout or [M lines)")
    need(all(launches[n] > 0 for n in TABLE_KERNELS),
         f"the table path never launched extract, resolve or the bloom: "
         f"{launches}")
    need(not any(v for n, v in launches.items() if n not in TABLE_KERNELS),
         f"the table path launched a merge or seghist kernel: {launches}")
    need(launches["resolve"] == len(calls),
         f"{launches['resolve']} resolve launches for {len(calls)} calls: "
         f"not one a call")
    mb_b = dict((n, mb) for n, _, mb, _ in SNP_SAMPLES)["B"]
    bases = (MBASES + mb_b) * 1_000_000 // READ_LEN * READ_LEN
    rounds = [c[0] for c in calls]
    say("table", f"KMER_TPU_TABLE_YAK=1 yak-count {' '.join(YAK2_ARGS)} A "
        f"B: {wall:.3f} s = {bases / 1e6 / wall:.2f} Mbases/s (phase 10, "
        f"the sort engine: {out['yak2']['wall']:.3f} s); stdout and "
        f"{len(got[1])} [M lines == phase 10's; peak device memory "
        f"{peak:.2f} GiB; final capacity {eng.table.capacity} slots, "
        f"{eng.rebuilds} rebuilds, {int(eng.table.n_full)} keys kept")
    say("table", f"resolve calls {len(calls)}, one launch each: "
        f"{sum(rounds)} rounds (at most {max(rounds)} a call), "
        f"{sum(c[1] for c in calls)} probe-lanes over "
        f"{sum(c[2] for c in calls)} lanes")
    for i, st in enumerate(eng.stats, 1):
        say("table", f"pass {i} IngestStats: {stats_line(st)}")
    say("table", f"launches in this run: {json.dumps(launches)}")
    del made, eng
    gc.collect()
    torch.cuda.empty_cache()

    # 5. a checkpoint after pass 1, resumed on the card
    ck_path = os.path.join(DATA_DIR, "table.ckpt.npz")
    e1 = yak.YakEngine(k=K, pre=10, bf_shift=30, bf_n_hash=4, device=dev)
    e1.count([path_a], create_new=True)
    t0 = time.perf_counter()
    e1.save_checkpoint(ck_path)
    save_s = time.perf_counter() - t0
    del e1
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    e2 = yak.YakEngine.resume_checkpoint(ck_path, device=dev)
    load_s = time.perf_counter() - t0
    e2.destroy_bloom()
    e2.clear()
    e2.count([path_b], create_new=False)
    e2.shrink(2, yak.YAK_MAX_COUNT)
    need(yak_rows_text(e2.hist()) == out["yak2"]["got"][0],
         "a YakEngine checkpoint resumed on the card != phase 10's stdout")
    say("table", f"checkpoint after pass 1 ({os.path.getsize(ck_path) / 1e6:.0f} "
        f"MB, the JAX package's layout): saved in {save_s:.1f} s, resumed "
        f"in {load_s:.1f} s; pass 2 + shrink == phase 10's stdout")
    os.remove(ck_path)
    del e2
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the table engine on phase 14's 4 shards of the card
    _build.reset_launches()
    with on_mesh(mesh_card()), setenv("KMER_TPU_TABLE_YAK", "1"), \
            recording_table_engines() as made:
        t0 = time.perf_counter()
        mgot = run_tool("yak-count", args)
        mwall = time.perf_counter() - t0
    mlaunch = dict(_build.LAUNCHES)
    need(type(made[0]) is yak.MeshYakEngine and made[0].n_dev == MESH_SHARDS
         and all(t.state.is_cuda for t in made[0].tables),
         "KMER_TPU_TABLE_YAK=1 on the mesh did not run MeshYakEngine on "
         "the card's shards")
    need(mgot == (out["yak2"]["got"][0], out["mesh"]["yak2_lines"]),
         "the table engine on the mesh != phase 10's stdout and phase 14's "
         "[M lines")
    need(all(mlaunch[n] > 0 for n in TABLE_KERNELS) and not any(
        v for n, v in mlaunch.items() if n not in TABLE_KERNELS),
         f"the mesh table path's launches: {mlaunch}")
    say("table", f"on {MESH_SHARDS} shards of the card: {mwall:.3f} s, "
        f"stdout == phase 10's, {len(mgot[1])} [M lines == phase 14's; "
        f"capacity {made[0].cap_local} a shard, {made[0].rebuilds} "
        f"rebuilds; launches {json.dumps(mlaunch)}")
    del made
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the table engine in phase 15's two processes
    res = run_multiproc("table", [
        {"name": "yak2_table", "kind": "tool", "tool": "yak-count",
         "args": args, "env": {"KMER_TPU_TABLE_YAK": "1"}}])
    p = [r["results"][0] for r in res]
    need(p[0]["out"] == out["yak2"]["got"][0] and p[1]["out"] == "",
         "the table engine on two processes != phase 10's stdout")
    need(p[0]["lines"] == out["multiproc"]["yak2"]["lines"],
         "the table engine on two processes: [M lines != phase 15's")
    for pid, q in enumerate(p):
        la = q["launches"]
        need((la["extract"] > 0 or pid) and la["resolve"] > 0 and not any(
            v for n, v in la.items() if n not in TABLE_KERNELS),
            f"the table path on process {pid}: launches {la}")
        say("table", f"  process {pid}: {mp_line(q, bases)}; launches "
            f"{json.dumps(la)}")
    sort_wall = out["multiproc"]["yak2"]["wall"]
    say("table", f"on {MP_PROCS} processes x {MP_SHARDS} shards: stdout == "
        f"phase 10's, {len(p[0]['lines'])} [M lines == phase 15's; wall "
        f"{p[0]['wall']:.3f} s against the sort engine's {sort_wall:.3f} s "
        f"in phase 15 ({p[0]['wall'] / sort_wall:.2f}x)")
    return {"row": row, "launches": launches, "parts": parts}


# -- KMER_TPU_DEBUG on the card ------------------------------------------

# scripts/tpu_smoke.py's CASES, on tests/fixtures/reads_small.fq.gz
DEBUG_CASES = (("kc-c1", ["-k21"]), ("kc-c2", ["-k31", "-p10"]),
               ("kc-c4", ["-k31"]), ("kc-c4", ["-k15"]),
               ("yak-count", ["-k21", "-b14"]))
DEBUG_CHUNK = 1 << 15  # stream chunk of the fixture runs, so ladders merge


def debug_switch():
    return setenv("KMER_TPU_DEBUG", "1")


@contextlib.contextmanager
def small_stream_chunks():
    """Stream ladders that merge at fixture sizes (one engine and mesh
    shards alike)."""
    from kmer_tpu_torch.dist import sharded
    from kmer_tpu_torch.table import compactor

    saved = compactor._STREAM_CHUNK, sharded._MESH_STREAM_CHUNK
    compactor._STREAM_CHUNK = sharded._MESH_STREAM_CHUNK = DEBUG_CHUNK
    try:
        yield
    finally:
        compactor._STREAM_CHUNK, sharded._MESH_STREAM_CHUNK = saved


def checked_run(fn, method):
    """fn() with the switch unset, then under it: (unset result, checked
    result, the checked run's launches, checks it made).  The unset run
    may make no check."""
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.table import compactor

    before = dict(compactor.DEBUG_CHECKS)
    plain = fn()
    need(compactor.DEBUG_CHECKS == before,
         f"a cross-check ran with KMER_TPU_DEBUG unset: "
         f"{compactor.DEBUG_CHECKS} after {before}")
    _build.reset_launches()
    with debug_switch():
        checked = fn()
    return (plain, checked, dict(_build.LAUNCHES),
            compactor.DEBUG_CHECKS[method] - before[method])


@contextlib.contextmanager
def timing_debug_checks():
    """Record each cross-check of the compactor: (method, device ms
    between two CUDA events around it, GiB it allocated beyond what was
    held as it began, the run's peak GiB before it, its plane)."""
    import torch

    from kmer_tpu_torch.table import compactor

    calls = []

    def timed(method, real):
        def check(plane, *a):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            peak_before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            a0 = torch.cuda.Event(enable_timing=True)
            b0 = torch.cuda.Event(enable_timing=True)
            a0.record()
            real(plane, *a)
            b0.record()
            torch.cuda.synchronize()
            calls.append((method, a0.elapsed_time(b0),
                          (torch.cuda.max_memory_allocated() - held) / 2**30,
                          peak_before / 2**30, plane))
        return check

    saved = compactor._check_hist, compactor._check_counts_for
    compactor._check_hist = timed("hist", saved[0])
    compactor._check_counts_for = timed("counts_for", saved[1])
    try:
        yield calls
    finally:
        compactor._check_hist, compactor._check_counts_for = saved


def seghist_fault(real):
    """The CUDA seghist wrapper with one count moved from its first filled
    bin to the next one."""
    def faulty(keys, weights, bins_cfg):
        hist, n_distinct = real(keys, weights, bins_cfg)
        hist = hist.clone()
        b = int(hist[1:-1].nonzero()[0]) + 1
        hist[b] -= 1
        hist[b + 1] += 1
        return hist, n_distinct
    return faulty


def merge_fault(real):
    """The CUDA merge wrapper with two adjacent lanes swapped where the
    first ends a run of two or more keys (in every merge that has one).
    The kernels only ever read sorted runs: an input that an earlier
    call left swapped is sorted again first."""
    import torch

    def faulty(a, b):
        a, b = (torch.sort(r).values if bool((r[1:] < r[:-1]).any()) else r
                for r in (a, b))
        out = real(a, b)
        at = ((out[1:-1] != out[2:]) & (out[1:-1] == out[:-2])).nonzero()
        if at.shape[0]:
            i = int(at[0]) + 1
            out[i:i + 2] = out[i:i + 2].flip(0)
        return out
    return faulty


def fault_runs(path):
    """kc-c4 -k31 on path with each CUDA wrapper of the checked plane
    corrupting one lane: under the switch the run raises the debug
    AssertionError, with the switch unset it exits 0.  Returns
    {fault: (its kernel's launches in the checked run, the message)}."""
    from kmer_tpu_torch.kernels import _build, merge, seghist

    seen = {}
    for mod, name, wrap, kernel in (
            (seghist, "segment_hist_sorted", seghist_fault, "seghist"),
            (merge, "merge_runs", merge_fault, "merge_path")):
        real = getattr(mod, name)
        setattr(mod, name, wrap(real))
        try:
            check_hist_text(run_kc_c4(["-k31", path]))
            _build.reset_launches()
            try:
                with debug_switch():
                    run_kc_c4(["-k31", path])
                msg = None
            except AssertionError as e:
                msg = str(e)
        finally:
            setattr(mod, name, real)
        need(msg is not None and msg.startswith("KMER_TPU_DEBUG: "),
             f"a corrupted {name} passed the debug check: {msg}")
        seen[name] = (_build.LAUNCHES[kernel], msg)
        need(seen[name][0] > 0, f"{kernel} never launched in the faulty run")
    return seen


def debug_wide_totals(seed):
    """KmerCompactors on the card and on the CPU holding the same two
    counted runs over 2^22 keys (a resumed checkpoint's run and a further
    one), in which 4 keys for each of U32_EDGES and 64 keys of the first
    run alone reach totals past 2^31 and 2^32; two-plane (key_bits 62)
    and one-plane (30).  Under KMER_TPU_DEBUG=1 every hist of the card's
    == the CPU's for U32_CFGS, no check raises, and seghist launches.
    Returns the keys past 2^31 and the checks made."""
    import numpy as np
    import torch

    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.kernels.keys import from_hi_lo
    from kmer_tpu_torch.table import compactor

    rng = np.random.default_rng(seed)
    n_keys, checks, wide = 1 << 22, 0, 0
    for key_bits in (62, 30):
        u = rng.permutation(np.unique(rng.integers(
            0, 1 << key_bits, n_keys + (n_keys >> 3), dtype=np.uint64))
            [:n_keys])
        c1 = rng.integers(1, 9, n_keys, dtype=np.uint64)
        c2 = rng.integers(1, 9, n_keys, dtype=np.uint64)
        n_edge = 4 * len(U32_EDGES)
        c1[:n_edge + 64] = rng.integers(1 << 31, 1 << 32, n_edge + 64,
                                        dtype=np.uint64)
        for i, total in enumerate(np.repeat(U32_EDGES, 4)):
            c2[i] = (int(total) - int(c1[i])) % (1 << 32)
        in2 = rng.random(n_keys) < 0.5
        in2[:n_edge + 64] = np.arange(n_edge + 64) < n_edge
        runs = [(u, c1), (u[in2], c2[in2])]
        comps = [compactor.KmerCompactor(dev, key_bits=key_bits)
                 for dev in ("cuda", "cpu")]
        for comp in comps:
            for k, c in runs:
                comp.add_counted(
                    from_hi_lo(k >> np.uint64(32), k & np.uint64(0xFFFFFFFF),
                               comp.device),
                    torch.from_numpy(c.astype(np.uint32).view(np.int32))
                    .to(comp.device))
        want_wide = sum(1 << 31 <= t % (1 << 32) for t in U32_EDGES) * 4 + 64
        with debug_switch():
            for cfg in U32_CFGS:
                before = compactor.DEBUG_CHECKS["hist"]
                launched = _build.LAUNCHES["seghist"]
                card, cpu = (comp.hist(*cfg) for comp in comps)
                need(np.array_equal(card[0], cpu[0]) and card[1] == cpu[1],
                     f"key_bits {key_bits} {cfg}: the card's hist with totals"
                     f" past 2^31 != the CPU's")
                need(cpu[0][-1] >= want_wide, f"key_bits {key_bits} {cfg}: "
                     f"{cpu[0][-1]} keys in the last bin, {want_wide} past "
                     "2^31")
                need(compactor.DEBUG_CHECKS["hist"] - before == 2
                     and _build.LAUNCHES["seghist"] > launched,
                     f"key_bits {key_bits} {cfg}: checks "
                     f"{compactor.DEBUG_CHECKS['hist'] - before}, seghist "
                     f"launches {_build.LAUNCHES['seghist'] - launched}")
                checks += 2
        wide += want_wide
        del comps, runs
    return wide, checks


def phase_debug(seed, out):
    """KMER_TPU_DEBUG=1 on the card: scripts/tpu_smoke.py's cases, the
    fixture SNP chain and a 4-shard mesh on tests/fixtures, kc-c4 -k31 on
    phase 4's file and vaf-counter on phase 9's sample A2, each equal to
    its run with the switch unset; the check's device time and memory;
    faults injected into the CUDA seghist and merge wrappers raise; key
    totals past 2^31 and 2^32 on the card == on the CPU, none raising."""
    import torch

    from kmer_tpu_torch.table import compactor

    t_phase = time.perf_counter()
    fix = os.path.join(HERE, "tests", "fixtures")
    reads = os.path.join(fix, "reads_small.fq.gz")
    say("debug", f"on {out['card']}")
    with small_stream_chunks():
        for tool, args in DEBUG_CASES:
            plain, checked, launches, n = checked_run(
                lambda: run_tool(tool, [*args, reads]), "hist")
            merges = (ONE_PLANE_KERNELS if "-k15" in args
                      else ("merge_partition", "merge_path"))
            need(checked == plain, f"{tool} {' '.join(args)}: stdout under "
                 "KMER_TPU_DEBUG=1 != with it unset")
            need(n == 1 and launches["seghist"] > 0
                 and all(launches[m] > 0 for m in merges),
                 f"{tool} {' '.join(args)}: {n} hist checks, launches "
                 f"{launches}")
            say("debug", f"{tool} {' '.join(args)} reads_small: same stdout, "
                f"hist checked once on the plane of {launches[merges[1]]} "
                f"{merges[1]} and {launches['seghist']} seghist launches")

        d = os.path.join(DATA_DIR, "debug_snp")
        fqs = {"sampleA1": os.path.join(fix, "sampleA1.fq.gz")}
        chain = snp_chain(d, os.path.join(fix, "genome_small.fa.gz"),
                          os.path.join(fix, "snps_small.bed"), fqs)
        plain, checked, launches, n = checked_run(
            lambda: run_snp_chain(d, chain[:2])[1], "counts_for")
        need(checked == plain and len(plain) == 2,
             f"fixture snp-pattern-gen -> vaf-counter under KMER_TPU_DEBUG=1:"
             f" files {sorted(checked)} differ from {sorted(plain)}")
        need(n == 2 and launches["merge_path"] > 0,
             f"the SNP chain made {n} counts_for checks, launches {launches}")
        say("debug", f"snp-pattern-gen -> vaf-counter sampleA1: same files, "
            f"counts_for checked twice on merge-path planes "
            f"({launches['merge_path']} merge_path launches)")

        with on_mesh(mesh_card()):
            plain, checked, launches, n = checked_run(
                lambda: run_kc_c4([f"-k{K}", reads]), "hist")
        need(checked == plain and n == MESH_SHARDS
             and launches["seghist"] >= MESH_SHARDS
             and launches["merge_path"] > 0,
             f"kc-c4 on {MESH_SHARDS} shards: same={checked == plain}, {n} "
             f"hist checks, launches {launches}")
        say("debug", f"kc-c4 -k{K} reads_small on {MESH_SHARDS} shards of the "
            f"card: same stdout, hist checked on each shard")

        faults = fault_runs(reads)
    for name, (n, msg) in faults.items():
        say("debug", f"{name} corrupting one lane: exit 0 with the switch "
            f"unset, under it ({n} launches) AssertionError: {msg}")
    wide, n = debug_wide_totals(seed)
    say("debug", f"counted runs over 2^22 keys, two-plane and one-plane, "
        f"{wide} key totals in [2^31, 2^32) and keys at 2^32 and past it: "
        f"the card's hist == the CPU's for bins_cfg {list(U32_CFGS)}, "
        f"{n} checks under KMER_TPU_DEBUG=1 and none raised")

    # kc-c4 -k31 on phase 4's 256 Mbase file, in turns: unset, under
    # the switch twice, unset
    path = reads_file(MBASES, seed)
    runs, general_ms = [], None
    for debug in (False, True, True, False):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(compactor.DEBUG_CHECKS)
        with (debug_switch() if debug else contextlib.nullcontext()), \
                timing_debug_checks() as calls:
            t0 = time.perf_counter()
            got = run_kc_c4([f"-k{K}", path])
            wall = time.perf_counter() - t0
            peak = max([torch.cuda.max_memory_allocated() / 2**30]
                       + [c[3] for c in calls])
        need(got == out["e2e"]["out"], f"kc-c4 (KMER_TPU_DEBUG "
             f"{'1' if debug else 'unset'}) != phase 4's stdout")
        need(compactor.DEBUG_CHECKS["hist"] - before["hist"] == debug
             and [c[0] for c in calls] == ["hist"] * debug,
             f"kc-c4 on {MBASES} Mbases made checks {calls}")
        runs.append((debug, wall, peak, calls[0][1:4] if debug else None))
        if debug and general_ms is None:
            plane = calls[0][4]
            n_lanes = int(plane[0].shape[0])
            general_ms = time_ms(
                lambda p: compactor._hist_general(*p, 256, None, 1),
                setup=lambda: plane, reps=3)
            del plane
        del calls
    bases = MBASES * 1_000_000 // READ_LEN * READ_LEN
    walls = ", ".join(f"{'debug' if d else 'unset'} {w:.3f} s"
                      for d, w, _, _ in runs)
    say("debug", f"kc-c4 -k{K} {MBASES} Mbases in turns: stdout == phase "
        f"4's in every run; walls {walls} (phase 4: "
        f"{out['e2e']['wall']:.3f} s); Mbases/s unset "
        + " / ".join(f"{bases / 1e6 / w:.2f}" for d, w, _, _ in runs
                     if not d) + ", debug "
        + " / ".join(f"{bases / 1e6 / w:.2f}" for d, w, _, _ in runs if d))
    for d, w, peak, check in runs:
        if d:
            ms, extra, _ = check
            say("debug", f"under KMER_TPU_DEBUG=1: the hist check {ms:.3f} ms "
                f"of device time on the plane of {n_lanes} lanes, "
                f"{extra:.3f} GiB allocated beyond what the run held; run "
                f"peak {peak:.2f} GiB")
        else:
            say("debug", f"unset: run peak {peak:.2f} GiB (phase 4: "
                f"{out['e2e']['peak']:.2f} GiB)")
    say("debug", f"_hist_general alone on that plane: {general_ms:.3f} ms "
        "(CUDA events, a mean of 3)")
    gc.collect()
    torch.cuda.empty_cache()

    # vaf-counter on phase 9's sample A2, phase 9's patterns
    fqs = snp_inputs(seed)[2]
    pat = os.path.join(DATA_DIR, "snp_card", "snps.pat")
    vaf = os.path.join(DATA_DIR, "debug_A2.vaf")
    with debug_switch(), timing_debug_checks() as calls:
        t0 = time.perf_counter()
        run_tool_err("vaf-counter", [f"-k{SNP_K}", "-v", "-p", pat, "-o",
                                     vaf, fqs["A2"]])
        wall = time.perf_counter() - t0
    need(read_file(vaf) == read_file(os.path.join(DATA_DIR, "snp_card",
                                                  "A2.vaf")),
         "vaf-counter A2 under KMER_TPU_DEBUG=1 != phase 9's VAF file")
    need([c[0] for c in calls] == ["counts_for"],
         f"vaf-counter A2 made checks {[c[0] for c in calls]}")
    _, check_ms, extra, _, plane = calls[0]
    say("debug", f"vaf-counter A2 (64 Mbases, phase 9's panel) under "
        f"KMER_TPU_DEBUG=1: VAF file == phase 9's; wall {wall:.3f} s; the "
        f"counts_for check {check_ms:.3f} ms of device time on the plane "
        f"of {int(plane[0].shape[0])} lanes, {extra:.3f} GiB allocated "
        "beyond what the run held")
    del calls, plane
    say("debug", f"checks made in this process: {compactor.DEBUG_CHECKS}; "
        f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"checks": dict(compactor.DEBUG_CHECKS)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        sys.stderr.write("chip_smoke: torch is not installed\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, HERE)
    try:
        import kmer_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.stderr.write(f"chip_smoke: the port is not here ({e})\n")
        return 2
    phases = (("card", phase_card), ("build", phase_build),
              ("kernels", lambda: phase_kernels(args.seed)),
              ("e2e", lambda: phase_e2e(args.seed)),
              ("budget", lambda: phase_budget(args.seed)),
              ("yak", lambda: phase_yak(args.seed)),
              ("packed", lambda: phase_packed(args.seed, out["e2e"],
                                              out["yak"])),
              ("onepl", lambda: phase_onepl(args.seed)),
              ("snp", lambda: phase_snp(args.seed, out["card"])),
              ("yak2", lambda: phase_yak2(args.seed)),
              ("edvaf", lambda: phase_edvaf(args.seed)),
              ("fixture", phase_fixture),
              ("hosttools", phase_hosttools),
              ("mesh", lambda: phase_mesh(args.seed, out)),
              ("multiproc", lambda: phase_multiproc(args.seed, out)),
              ("table", lambda: phase_table(args.seed, out)),
              ("debug", lambda: phase_debug(args.seed, out)))
    out = {}
    try:
        for phase, fn in phases:
            out[phase] = fn()
            no_jax_package(phase)
    except Exception:  # noqa: BLE001 - report which phase failed, exit 1
        traceback.print_exc()
        print(f"[{phase}] FAILED", flush=True)
        return 1
    card, rows = out["card"], out["kernels"]
    launches = dict(out["e2e"]["launches"])
    # each kernel's count from the path that it serves (module docstring)
    for name in ONE_PLANE_KERNELS:
        launches[name] = out["onepl"]["launches"][name]
    for name in YAK_TAP_KERNELS:
        launches[name] = out["yak"]["launches"][name]
    launches["resolve"] = out["table"]["launches"]["resolve"]
    rows["resolve"] = {k: v for k, v in out["table"]["row"].items()
                       if k not in ("rounds", "probes")}
    launches["myers"] = out["edvaf"]["launches"]["myers"]
    launches["myers_multiword"] = out["edvaf"]["long_launches"][
        "myers_multiword"]
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, src, rep in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
