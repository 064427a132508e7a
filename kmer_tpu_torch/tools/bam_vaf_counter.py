"""bam-vaf-counter — VAF from aligned reads, counting bases at SNP
positions directly (no k-mers; a copy of
kmer_tpu/tools/bam_vaf_counter.py: host code only).

Reference parity with the reference's bam-vaf-counter.c:472-578:
patterns -> merged single-position region list -> indexed BAM iteration
(sequential fallback without .bai) -> per-read CIGAR walk to the SNP
base -> ref/alt counts -> VAF file keyed by 0-based BED start.

The BAM/BGZF/.bai machinery is our own minimal htslib-equivalent
(io/bam.py, io/bgzf.py).  The per-read work is position lookup over a
handful of SNPs, so it stays on the host.
"""

from __future__ import annotations

import os
import sys
from bisect import bisect_left

from ..io.bam import FDUP, FQCFAIL, FUNMAP, open_alignment
from ..io.formats import read_patterns, write_vaf_file
from ..utils.cli import c_atoi, ketopt
from ..utils.log import minfo


def count_base_at_position(rec, ref_pos: int, ref_base: str, alt_base: str):
    """CIGAR walk (bam-vaf-counter.c:238-287): returns 'ref', 'alt', or None."""
    read_pos = 0
    cur = rec.pos
    for op, ln in rec.cigar:
        if op in (0, 7, 8):  # M, =, X
            if cur <= ref_pos < cur + ln:
                i = read_pos + (ref_pos - cur)
                if i >= rec.l_seq:  # record without stored SEQ ('*')
                    return None
                base = rec.base_at(i)
                if base == ref_base:
                    return "ref"
                if base == alt_base:
                    return "alt"
                return None
            read_pos += ln
            cur += ln
        elif op in (1, 4):  # I, S
            read_pos += ln
        elif op in (2, 3):  # D, N
            if cur <= ref_pos < cur + ln:
                return None
            cur += ln
        # H/P: nothing
    return None


def build_regions(patterns):
    """Sorted, merged single-position regions (bam-vaf-counter.c:124-175)."""
    regions = sorted(
        ((p.chr, p.start, p.start + 1) for p in patterns),
        key=lambda r: (r[0], r[1]),
    )
    merged = []
    for chrom, beg, end in regions:
        if merged and merged[-1][0] == chrom and merged[-1][2] >= beg:
            if end > merged[-1][2]:
                merged[-1] = (chrom, merged[-1][1], end)
        else:
            merged.append((chrom, beg, end))
    return merged


def _process_read(rec, by_tid, counts):
    """Count this read's base at every overlapping SNP.

    The reference scans its pattern array linearly per read
    (bam-vaf-counter.c:303-317); output-equivalent but O(patterns) per
    read.  Here the per-tid patterns are sorted by start and bisected,
    so each read touches only its overlapping SNPs."""
    if rec.flag & (FUNMAP | FQCFAIL | FDUP):
        return
    pats = by_tid.get(rec.tid)
    if not pats:
        return
    starts, entries = pats
    ref_end = rec.end_pos()
    i = bisect_left(starts, rec.pos)
    while i < len(starts) and starts[i] < ref_end:
        j, pat = entries[i]
        got = count_base_at_position(rec, pat.start, pat.ref, pat.alt)
        if got == "ref":
            counts[j][0] += 1
        elif got == "alt":
            counts[j][1] += 1
        i += 1


def count_bam_variants(fn, patterns, p_tids, regions, counts):
    """Process one alignment file.  p_tids holds each pattern's tid as
    resolved against the FIRST file's header (create_snp_map,
    bam-vaf-counter.c:187-215) — the reference never re-resolves them
    for later files, and reads are filtered by comparing those tids to
    the current file's record tids (bam-vaf-counter.c:298-301), so we
    deliberately do the same."""
    try:
        bam = open_alignment(fn)  # BAM or SAM text (sam_open analog)
    except OSError:
        sys.stderr.write(f"Error: failed to open BAM file: {fn}\n")
        return
    grouped = {}
    for j, p in enumerate(patterns):
        if p_tids[j] >= 0:
            grouped.setdefault(p_tids[j], []).append((j, p))
    by_tid = {}
    for tid, entries in grouped.items():
        entries.sort(key=lambda e: e[1].start)
        by_tid[tid] = ([p.start for _, p in entries], entries)
    idx = None
    # indexed access: .bai for BAM, .crai for CRAM; SAM text has neither
    cands = bam.index_candidates(fn) if hasattr(bam, "query") else ()
    for cand in cands:
        if os.path.exists(cand):
            try:
                idx = bam.load_index(cand)
            except ValueError:
                idx = None
            break
    if idx is not None and regions:
        minfo(
            "count_bam_variants",
            f"Using indexed access to fetch reads from {len(regions)} target regions",
        )
        for chrom, beg, end in regions:
            tid = bam.name2tid.get(chrom, -1)
            if tid < 0:
                sys.stderr.write(f"Warning: chromosome {chrom} not found in BAM\n")
                continue
            for rec in bam.query(idx, tid, beg, end):
                _process_read(rec, by_tid, counts)
    else:
        sys.stderr.write(
            f"[E::idx_find_and_load] Could not retrieve index file for '{fn}'\n"
        )
        minfo(
            "count_bam_variants",
            f"Warning: failed to load BAM index for {fn}, processing all reads",
        )
        if not (hasattr(bam, "query") and _count_sequential_native(
            fn, patterns, p_tids, counts
        )):
            for rec in bam.records():
                _process_read(rec, by_tid, counts)
    bam.close()


def _count_sequential_native(fn, patterns, p_tids, counts) -> bool:
    """Whole-file scan in the C++ reader (io/native/bam_count.cpp);
    returns False when unavailable so the Python loop runs instead."""
    from ..io import native

    order = []
    for j, p in enumerate(patterns):
        if p_tids[j] >= 0 and len(p.ref) == 1 and len(p.alt) == 1:
            order.append((p_tids[j], p.start, j))
    if len(order) != sum(t >= 0 for t in p_tids):
        return False  # odd patterns: keep one code path
    order.sort()
    tids = [t for t, _, _ in order]
    starts = [s for _, s, _ in order]
    refs = [ord(patterns[j].ref) for _, _, j in order]
    alts = [ord(patterns[j].alt) for _, _, j in order]
    out = native.bam_count_native(fn, tids, starts, refs, alts)
    if out is None:
        return False
    ref_counts, alt_counts = out
    for i, (_, _, j) in enumerate(order):
        counts[j][0] += int(ref_counts[i])
        counts[j][1] += int(alt_counts[i])
    return True


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_thread = 4
    pattern_fn = out_fn = None
    opts, pos = ketopt(argv, "p:o:t:")
    for c, a in opts:
        if c == "p":
            pattern_fn = a
        elif c == "o":
            out_fn = a
        elif c == "t":
            n_thread = c_atoi(a)
    if not pattern_fn or not out_fn or len(pos) < 1:
        e = sys.stderr
        e.write(
            "Usage: bam-vaf-counter [options] -p <patterns.txt> -o <output.vaf> <reads.bam> [reads2.bam ...]\n"
        )
        e.write("Options:\n")
        e.write("  -p FILE   input pattern file\n")
        e.write("  -o FILE   output VAF file\n")
        e.write(f"  -t INT    number of threads [{n_thread}]\n")
        e.write(
            "\nNote: This version directly counts ref/alt bases at SNP positions (no k-mer extraction).\n"
        )
        e.write("      It is much faster than k-mer-based counting.\n")
        return 1

    minfo("main", "Loading patterns...")
    try:
        patterns = read_patterns(pattern_fn)
    except OSError:
        sys.stderr.write("Error: failed to load pattern file\n")
        return 1
    minfo("main", f"Loaded {len(patterns)} patterns")

    # tid resolution against the FIRST file's header, once
    # (bam-vaf-counter.c:510-528): later files reuse these tids
    minfo("main", "Reading BAM header...")
    try:
        hdr_bam = open_alignment(pos[0])
    except OSError:
        sys.stderr.write(f"Error: failed to open BAM file: {pos[0]}\n")
        return 1
    minfo("main", "Creating SNP position map...")
    p_tids = []
    seen = set()
    for p in patterns:
        tid = hdr_bam.name2tid.get(p.chr, -1)
        if tid < 0:
            sys.stderr.write(
                f"Warning: chromosome {p.chr} not found in BAM header\n"
            )
        else:
            key = (tid, p.start)
            if key in seen:
                sys.stderr.write(
                    f"Warning: duplicate SNP at {p.chr}:{p.start}\n"
                )
            else:
                seen.add(key)
        p_tids.append(tid)
    hdr_bam.close()

    minfo("main", "Building target regions from patterns...")
    regions = build_regions(patterns)
    minfo(
        "main",
        f"Built {len(regions)} target regions (merged from {len(patterns)} patterns)",
    )

    minfo("main", f"Counting variants in BAM files with {n_thread} threads...")
    counts = [[0, 0] for _ in patterns]
    for fn in pos:
        minfo("main", f"Processing {fn}...")
        count_bam_variants(fn, patterns, p_tids, regions, counts)

    for j, p in enumerate(patterns):
        p.ref_count, p.alt_count = counts[j]

    minfo("main", "Writing VAF file...")
    avg_depth = write_vaf_file(out_fn, patterns)
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")
    return 0
