"""vaf-counter — count SNP pattern k-mers in FASTQ reads, emit VAF file.

Reference parity with the reference tool vaf-counter.c:584-738: loads the
8-column pattern file, builds a combined canonical-k-mer ->
(pattern_idx<<1|is_alt) map, streams FASTQ blocks extracting canonical
k-mers, looks each up and accumulates per-SNP ref/alt counts, then
writes the VAF file (depth header + %.4f VAF rows) and optional -v
performance report.

Port of kmer_tpu/tools/vaf_counter.py: reads stream through the same
sort-based count engine as the kc-c4 counter (the extraction kernel,
the stream-sorted ladder), and ALL pattern k-mers resolve at the end
with one `counts_for` call (compactor.counts_for: two binary searches a
map key over the sorted key plane) — the analog of worker_lookup's
per-k-mer hash probe + atomic increments (vaf-counter.c:449-479), turned
inside out.  In a run of several processes only process 0 writes the
VAF file (utils.log.is_primary); the counts are the same on every one.

Spans (utils/trace.py): `vaf.patterns` (the pattern file's load) and
`vaf.kmer_map` (create_combined_kmer_map).  Under -v a file's time ends
after the engine's devices have finished its work.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..io.formats import read_patterns, write_vaf_file
from ..pipeline.counter import make_count_engine
from ..utils import trace
from ..utils.cli import c_atoi, ketopt
from ..utils.log import is_primary, minfo, verbose, warn
from ..utils.seq import canonical_kmer, encode_kmer, hash64_np


def create_combined_kmer_map(patterns, k: int):
    """vaf-counter.c:198-252 — canonical ref/alt k-mers -> packed value.

    Returns sentinel-padded numpy arrays (key_hi, key_lo, value), plus
    the map entry count."""
    seen = {}
    n_collisions = 0
    mask = (1 << (2 * k)) - 1
    for i, p in enumerate(patterns):
        for kmer_str, flag in ((p.ref_kmer, 0), (p.alt_kmer, 1)):
            enc = encode_kmer(kmer_str.encode("latin-1"), k)
            if enc < 0:
                continue
            can = canonical_kmer(enc, k)
            if can in seen:
                n_collisions += 1  # first value wins (absent-only insert)
            else:
                seen[can] = (i << 1) | flag
    if n_collisions > 0:
        warn(
            "create_combined_kmer_map",
            f"Warning: {n_collisions} k-mer collisions detected. "
            "Some patterns may have overlapping k-mers.",
        )
    n = len(seen)
    size = max(256, 1 << int(np.ceil(np.log2(max(n, 1)))))
    khash = hash64_np(np.fromiter(seen.keys(), np.uint64, n), mask)
    phi = np.full(size, 0xFFFFFFFF, np.uint32)
    plo = np.full(size, 0xFFFFFFFF, np.uint32)
    pval = np.full(size, 0xFFFFFFFF, np.uint32)
    phi[:n] = (khash >> np.uint64(32)).astype(np.uint32)
    plo[:n] = (khash & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pval[:n] = np.fromiter(seen.values(), np.uint32, n)
    return phi, plo, pval, n


def _device_name(device) -> str:
    """The -v report's device: the card's name, or `cpu` (the JAX
    package's device kind on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _synchronize(eng) -> None:
    """Wait for the work queued on each CUDA device of the engine (its
    mesh's, where it has one)."""
    mesh = getattr(eng, "mesh", None)
    for dev in (mesh.devices if mesh is not None else [eng.device]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k, n_thread, block_size = 21, 4, 10_000_000
    pattern_fn = out_fn = None
    verbose_mode = False
    opts, pos = ketopt(argv, "k:p:o:t:b:v")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "p":
            pattern_fn = a
        elif c == "o":
            out_fn = a
        elif c == "t":
            n_thread = c_atoi(a)
        elif c == "b":
            block_size = c_atoi(a)
        elif c == "v":
            verbose_mode = True
    if not pattern_fn or not out_fn or len(pos) < 1:
        e = sys.stderr
        e.write(
            "Usage: vaf-counter [options] -p <patterns.txt> -o <output.vaf> <reads.fq> [reads2.fq ...]\n"
        )
        e.write("Options:\n")
        e.write(f"  -k INT    k-mer length [{k}]\n")
        e.write("  -p FILE   input pattern file\n")
        e.write("  -o FILE   output VAF file\n")
        e.write(f"  -t INT    number of threads [{n_thread}]\n")
        e.write(f"  -b INT    block size [{block_size}]\n")
        e.write("  -v        verbose mode (report performance statistics)\n")
        return 1

    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1

    t_start = time.time()
    minfo("main", "Loading patterns...")
    t0 = time.time()
    try:
        with trace.span("vaf.patterns"):
            patterns = read_patterns(pattern_fn)
    except OSError:
        sys.stderr.write("Error: failed to load pattern file\n")
        return 1
    time_pattern_load = time.time() - t0
    minfo("main", f"Loaded {len(patterns)} patterns in {time_pattern_load:.3f} sec")

    minfo("main", "Creating k-mer map...")
    t0 = time.time()
    with trace.span("vaf.kmer_map"):
        phi, plo, pval, n_entries = create_combined_kmer_map(patterns, k)
    time_map_create = time.time() - t0
    if verbose_mode:
        verbose(
            "create_combined_kmer_map",
            f"Created k-mer map with {n_entries} entries in {time_map_create:.3f} sec",
        )

    minfo("main", f"Counting k-mers in FASTQ files with {n_thread} threads...")
    t0 = time.time()
    total_bases = total_seqs = total_kmers = 0
    # Stream every file into the sort-based count engine (identical
    # machinery to the kc-c4 counter), then resolve all pattern k-mers
    # with ONE global sort-join (counts_for).  Joining once at the end
    # beats a per-block join ~3x: the per-block sort pays 4 planes per
    # lane per block, the global engine 2 planes once.
    eng = make_count_engine(k=k, block_bases=block_size,
                            qual_policy=("resume", k, 3))
    for fn in pos:
        minfo("main", f"Processing {fn}...")
        t_file = time.time()
        b0, s0 = eng.total_bases, eng.total_seqs
        try:
            eng.count_paths([fn])
        except OSError:
            continue  # unopenable input: silent skip, like the
            # reference's `if ((fp = gzopen(fn, "r")) == 0) return;`
            # (vaf-counter.c:557)
        if verbose_mode:
            _synchronize(eng)  # the file's device work, in its time
            el = time.time() - t_file
            fb, fs = eng.total_bases - b0, eng.total_seqs - s0
            verbose(
                "count_fastq_kmers",
                f"Processed {fn}: {fs} sequences, {fb} bases in "
                f"{el:.2f} sec ({fb / el / 1e6:.2f} Mbases/sec)",
            )
    total_bases, total_seqs = eng.total_bases, eng.total_seqs
    total_kmers = eng.total_kmers
    # only the real map rows — the padding rows are the sentinel key,
    # which would otherwise collect the invalid-lane count
    qcounts = eng.counts_for(phi[:n_entries], plo[:n_entries])
    time_counting = time.time() - t0

    counts_np = np.zeros(2 * len(patterns), np.int64)
    for q in range(n_entries):
        counts_np[int(pval[q])] = int(qcounts[q])
    for i, p in enumerate(patterns):
        p.ref_count = int(counts_np[2 * i])
        p.alt_count = int(counts_np[2 * i + 1])

    minfo("main", "Writing VAF file...")
    t0 = time.time()
    if is_primary():  # one VAF file a run (the counts are all-reduced)
        avg_depth = write_vaf_file(out_fn, patterns)
    else:
        total = sum(p.ref_count + p.alt_count for p in patterns)
        avg_depth = total / (len(patterns) if patterns else 1)
    time_write = time.time() - t0
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")

    if verbose_mode:
        total_time = time.time() - t_start
        e = sys.stderr
        e.write("\n=== Performance Statistics ===\n")
        e.write(f"Total runtime:           {total_time:.3f} sec\n")
        e.write(
            f"  Pattern loading:       {time_pattern_load:.3f} sec ({100.0 * time_pattern_load / total_time:.1f}%)\n"
        )
        e.write(
            f"  K-mer map creation:    {time_map_create:.3f} sec ({100.0 * time_map_create / total_time:.1f}%)\n"
        )
        e.write(
            f"  K-mer counting:        {time_counting:.3f} sec ({100.0 * time_counting / total_time:.1f}%)\n"
        )
        e.write(
            f"  Output writing:        {time_write:.3f} sec ({100.0 * time_write / total_time:.1f}%)\n"
        )
        e.write("\nThroughput:\n")
        e.write(f"  Sequences processed:   {total_seqs}\n")
        e.write(
            f"  Bases processed:       {total_bases} ({total_bases / 1e6:.2f} Mbases)\n"
        )
        e.write(
            f"  K-mers extracted:      {total_kmers} ({total_kmers / 1e6:.2f} million)\n"
        )
        if time_counting > 0:
            e.write(
                f"  Speed:                 {total_bases / time_counting / 1e6:.2f} Mbases/sec\n"
            )
            e.write(
                f"  K-mer throughput:      {total_kmers / time_counting / 1e6:.2f} million k-mers/sec\n"
            )
        e.write("\nMemory:\n")
        e.write(f"  Patterns:              {len(patterns)}\n")
        e.write(f"  Pattern map entries:   {n_entries}\n")
        e.write(f"  Pattern map capacity:  {phi.shape[0]}\n")
        e.write("\nOptimizations:\n")
        e.write(f"  Device:                {_device_name(eng.device)}\n")
        e.write(f"  Threads:               {n_thread} workers\n")
        e.write("==============================\n")
    return 0
