"""snp-pattern-gen — extract unique SNP k-mer patterns from a genome.

Reference parity with the reference tool snp-pattern-gen.c:219-367:
3-pass design — (1) BED -> candidate ref/alt canonical k-mers seeded at
count 0, (2) whole-genome scan counting only candidates, (3) emit SNPs
whose ref k-mer occurs exactly once and alt k-mer never.

Port of kmer_tpu/tools/snp_pattern_gen.py: pass 2 counts the whole
genome on the port's engine (records of mixed length take the flat
extraction form) and reads the candidates' counts back with
one `counts_for` call (the candidate-map filter of
count_candidate_kmers, snp-pattern-gen.c:162-190, falls out of querying
only candidates); passes 1/3 are tiny host-side k-mer ops.  In a run of
several processes only process 0 writes the pattern file
(utils.log.is_primary); the others write to os.devnull.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.fastx import FastxReader
from ..io.formats import read_bed_snps, write_pattern_row
from ..pipeline.counter import make_count_engine
from ..utils.cli import c_atoi, ketopt
from ..utils.log import is_primary, minfo
from ..utils.seq import canonical_kmer, encode_kmer, hash64_np


def extract_snp_kmer(seq: bytes, pos: int, alt: str, k: int):
    """snp-pattern-gen.c:193-217: k-mer centered on the SNP (flank=k/2),
    alt base substituted at the center; None if out of range or has N."""
    flank = k // 2
    start = pos - flank
    if start < 0 or start + k > len(seq):
        return None
    window = seq[start : start + k]
    ref_enc = encode_kmer(window, k)
    if ref_enc < 0:
        return None
    alt_bytes = window[:flank] + alt.encode("latin-1") + window[flank + 1 :]
    return window, alt_bytes


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k = 21
    bed_fn = fasta_fn = out_fn = None
    opts, _pos = ketopt(argv, "k:b:f:o:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "b":
            bed_fn = a
        elif c == "f":
            fasta_fn = a
        elif c == "o":
            out_fn = a
    if k % 2 == 0:
        sys.stderr.write("Error: k must be odd\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    if not bed_fn or not fasta_fn or not out_fn:
        e = sys.stderr
        e.write(
            f"Usage: snp-pattern-gen -k {k} -b <snps.bed> -f <ref.fa> -o <patterns.txt>\n"
        )
        e.write("Options:\n")
        e.write(f"  -k INT    k-mer length (must be odd) [{k}]\n")
        e.write("  -b FILE   input BED file with SNPs\n")
        e.write("  -f FILE   input reference genome FASTA file\n")
        e.write("  -o FILE   output pattern file\n")
        return 1

    minfo("main", "Loading reference genome...")
    genome = {}
    order = 0
    try:
        for name, seq in FastxReader(fasta_fn):
            genome[name.decode("latin-1")] = seq
            order += 1
    except OSError:
        sys.stderr.write("Error: failed to load FASTA file\n")  # :256
        return 1
    minfo("main", f"Loaded {order} sequences")

    # pass 1: candidate canonical k-mers from the BED
    minfo("main", "Generating candidate k-mers from BED file...")
    try:
        snps = read_bed_snps(bed_fn)
    except OSError:
        sys.stderr.write("Error: failed to open BED file\n")  # :265
        return 1
    mask = (1 << (2 * k)) - 1
    candidates = {}
    per_snp = []  # (snp, ref_kmer_str, alt_kmer_str, ref_can, alt_can) or None
    for s in snps:
        seq = genome.get(s.chr)
        if seq is None:
            per_snp.append(None)
            continue
        got = extract_snp_kmer(seq, s.start, s.alt, k)
        if got is None:
            per_snp.append(("skip",))
            continue
        ref_b, alt_b = got
        ref_enc = encode_kmer(ref_b, k)
        alt_enc = encode_kmer(alt_b, k)
        if ref_enc < 0 or alt_enc < 0:
            per_snp.append(("skip",))
            continue
        ref_can = canonical_kmer(ref_enc, k)
        alt_can = canonical_kmer(alt_enc, k)
        candidates.setdefault(ref_can, 0)
        candidates.setdefault(alt_can, 0)
        per_snp.append((s, ref_b.decode("latin-1"), alt_b.decode("latin-1"), ref_can, alt_can))
    minfo("main", f"Generated {len(candidates)} candidate k-mers")

    # pass 2: scan the genome, then sort-join the candidate set against
    # the accumulated k-mer runs (the "count only candidates" filter of
    # snp-pattern-gen.c:162-190 falls out of querying only candidates)
    minfo("main", "Counting candidate k-mers in genome...")
    eng = make_count_engine(k=k)
    eng.count_paths([fasta_fn])
    minfo("main", "Finished counting k-mers")

    # pass 3: emit SNPs with ref count == 1 and alt count == 0
    minfo("main", "Processing SNPs...")
    query = []
    for e in per_snp:
        if e is not None and len(e) == 5:
            query.extend([e[3], e[4]])
    counts = {}
    if query:
        qk = np.asarray(query, np.uint64)
        qh = hash64_np(qk, mask)
        got = eng.counts_for(
            (qh >> np.uint64(32)).astype(np.uint32),
            (qh & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
        for key, cnt in zip(qk.tolist(), got.tolist()):
            counts[key] = cnt

    n_total = n_unique = 0
    # one pattern file a run (the counts are the same on every process)
    out_path = out_fn if is_primary() else os.devnull
    with open(out_path, "w", encoding="latin-1") as out_fp:
        for entry in per_snp:
            n_total += 1
            if entry is None:
                # chromosome not found (warning, snp-pattern-gen.c:332)
                sys.stderr.write(
                    f"Warning: chromosome {snps[n_total - 1].chr} not found\n"
                )
                continue
            if len(entry) == 1:
                continue
            s, ref_str, alt_str, ref_can, alt_can = entry
            if counts.get(ref_can) == 1 and counts.get(alt_can) == 0:
                write_pattern_row(out_fp, s, ref_str, alt_str)
                n_unique += 1
    minfo("main", f"Total SNPs: {n_total}, Unique k-mer pairs: {n_unique}")
    return 0
