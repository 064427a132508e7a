"""ed-vaf-counter: VAF by approximate pattern search in reads (port of
kmer_tpu/tools/ed_vaf_counter.py).

For every read and every pattern, count the optimal end locations of
the ref and alt k-mers within edit distance -e (edlib's HW/LOC
semantics), then write the standard VAF file.  The search is the Myers
bit-vector scan (kernels/myers.py) on the default device, in batches of
reads by length bucket: on the card (default_device(): CUDA) the
kernels of csrc/myers.cu, one launch a batch (and one more a batch for
patterns longer than 32 bases); with KMER_TPU_PLATFORM=cpu their plain
torch versions.

As in the JAX tool: the alphabet is the raw bytes of the patterns (no
case folding, N == N, every other read byte one never-match code); an
alt k-mer is truncated or NUL-padded to its ref k-mer's length; patterns
longer than 32 bases go through one multiword batch; an input that
cannot be opened is skipped with a warning.  Two differences of form,
which change no count: a batch runs only its filled rows (JAX runs the
bucket's static shape with the rest zero-length), and the pattern axis
is not padded to a multiple of 128 lanes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import default_device
from ..io.fastx import FastxReader
from ..io.formats import read_patterns, write_vaf_file
from ..kernels.myers import (build_peq, build_peq_multiword,
                             myers_hw_counts, myers_hw_counts_multiword)
from ..utils.cli import c_atoi, ketopt
from ..utils.log import minfo

# reads are batched by length bucket (powers of 4 from 1 KiB), so reads
# of any length (nanopore/PacBio) go through as the reference's edlib
# takes them
_MIN_BUCKET = 1024
_BATCH_BYTES = 1 << 21  # rows per bucket = _BATCH_BYTES // bucket
_KERNEL_MAX_PAT = 32  # one-word limit; longer -> multi-word batch


def _bucket_for(length: int) -> int:
    b = _MIN_BUCKET
    while b < length:
        b *= 4
    return b


def _alphabet_lut(kmers):
    """edlib compares RAW bytes (no case folding, 'N' == 'N'): its
    transformSequences maps each distinct byte to its own letter
    (edlib.cpp:1417).  Reproduce that with the alphabet of distinct
    PATTERN bytes; read bytes outside it map to one catch-all code that
    matches nothing (equality against a pattern byte is all that
    counting needs)."""
    alpha = sorted(set(b"".join(kmers)))
    n_alpha = max(1, len(alpha))
    assert n_alpha <= 255, "pattern bytes exceed the uint8 code space"
    # (the 255 buffer fill below stays a never-match code)
    lut = np.full(256, n_alpha, np.uint8)
    for idx, byte in enumerate(alpha):
        lut[byte] = idx
    return lut, n_alpha


def _encode(seq: bytes, lut) -> np.ndarray:
    return lut[np.frombuffer(seq, np.uint8)]


def _openable(fn) -> bool:
    if fn == "-":
        return True
    try:
        open(fn, "rb").close()
        return True
    except OSError:
        return False


def _pattern_kmers(patterns):
    """The search strings, ref then alt a pattern.  The reference caches
    kmer_len = strlen(ref_kmer) once and passes it for BOTH searches
    (ed-vaf-counter.c:77,143-146): an alt k-mer longer than its ref is
    truncated to the ref's length; a shorter one is searched over the
    ref's length, its NUL then padding."""
    kmers = []
    for p in patterns:
        r = p.ref_kmer.encode("latin-1")
        a = p.alt_kmer.encode("latin-1")
        m = len(r)
        a = a[:m] if len(a) >= m else a + b"\x00" * (m - len(a))
        kmers.append(r)
        kmers.append(a)
    return kmers


def _code_matrix(kmers, lut, width: int):
    """(codes (P, width) uint8 with the 255 fill, lengths (P,) int32)."""
    pc = np.full((len(kmers), width), 255, np.uint8)
    plen = np.zeros(len(kmers), np.int32)
    for i, x in enumerate(kmers):
        pc[i, :len(x)] = _encode(x, lut)
        plen[i] = len(x)
    return pc, plen


def count_fastq(fn, patterns, max_e, totals, device):
    """Accumulate per-pattern (ref, alt) counts over all reads in fn."""
    if not _openable(fn):
        # ed-vaf-counter.c:130
        sys.stderr.write(f"Warning: failed to open {fn}\n")
        return
    kmers = _pattern_kmers(patterns)
    lut, n_alpha = _alphabet_lut(kmers)
    long_idx = [i for i, x in enumerate(kmers) if len(x) > _KERNEL_MAX_PAT]
    if long_idx:
        # one multi-word batch covers every long pattern
        lp_long = max(len(kmers[i]) for i in long_idx)
        n_words = (lp_long + 31) // 32
        pcl, plenl = _code_matrix([kmers[i] for i in long_idx], lut, lp_long)
        plenl = torch.from_numpy(plenl).to(device)
        peq_long = build_peq_multiword(torch.from_numpy(pcl).to(device),
                                       plenl, n_alpha, n_words)
    lp = max((len(x) for x in kmers if len(x) <= _KERNEL_MAX_PAT),
             default=1)
    # a long pattern's one-word lane is a dummy (the multiword batch
    # counts it): empty codes over lp bases
    pc, plen = _code_matrix(
        [b"" if len(x) > _KERNEL_MAX_PAT else x for x in kmers], lut, lp)
    plen[long_idx] = lp
    plen = torch.from_numpy(plen).to(device)
    peq = build_peq(torch.from_numpy(pc).to(device), plen, n_alpha)

    acc = np.zeros(len(kmers), np.int64)
    batches = {}  # bucket -> [codes2d, lens, fill]

    def flush(bucket):
        codes, lens, nb = batches.pop(bucket)
        if nb == 0:
            return
        codes = torch.from_numpy(codes[:nb]).to(device)
        lens = torch.from_numpy(lens[:nb]).to(device)
        ksum = myers_hw_counts(peq, plen, codes, lens, max_e).sum(0)
        ksum = ksum.cpu().numpy()
        ksum[long_idx] = 0  # dummy lanes; the multi-word batch owns them
        acc[:] += ksum
        if long_idx:
            lsum = myers_hw_counts_multiword(peq_long, plenl, codes, lens,
                                             max_e, n_words).sum(0)
            acc[long_idx] += lsum.cpu().numpy()

    for _name, seq in FastxReader(fn):
        L = len(seq)
        bucket = _bucket_for(max(L, 1))
        if bucket not in batches:
            rows = max(4, _BATCH_BYTES // bucket)
            batches[bucket] = [
                np.full((rows, bucket), 255, np.uint8),
                np.zeros(rows, np.int32),
                0,
            ]
        codes, lens, nb = batches[bucket]
        codes[nb, :L] = _encode(seq, lut)
        codes[nb, L:] = 255
        lens[nb] = L
        batches[bucket][2] = nb + 1
        if batches[bucket][2] == codes.shape[0]:
            flush(bucket)
    for bucket in list(batches):
        flush(bucket)
    for i in range(len(patterns)):
        totals[i][0] += int(acc[2 * i])
        totals[i][1] += int(acc[2 * i + 1])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    max_e = 0
    pattern_fn = out_fn = None
    opts, pos = ketopt(argv, "p:o:e:")
    for c, a in opts:
        if c == "p":
            pattern_fn = a
        elif c == "o":
            out_fn = a
        elif c == "e":
            max_e = c_atoi(a)
    if not pattern_fn or not out_fn or len(pos) < 1:
        e = sys.stderr
        e.write(
            "Usage: ed-vaf-counter [options] -p <patterns.txt> -o <output.vaf> <reads.fq> [reads2.fq ...]\n"
        )
        e.write("Options:\n")
        e.write("  -p FILE   input pattern file\n")
        e.write("  -o FILE   output VAF file\n")
        e.write(
            f"  -e INT    maximum edit distance for approximate matching [{max_e}]\n"
        )
        e.write("\nDescription:\n")
        e.write("  This program uses edlib to search for pattern k-mers in FASTQ reads.\n")
        e.write("  Unlike vaf-counter which extracts all k-mers from reads and looks them up,\n")
        e.write("  ed-vaf-counter searches for each pattern k-mer in the reads using approximate\n")
        e.write("  string matching. This can be more efficient for small pattern sets.\n")
        e.write("  Set -e 0 for exact matches only (default), or higher values to allow mismatches.\n")
        return 1

    device = default_device()
    minfo("main", "Loading patterns...")
    try:
        patterns = read_patterns(pattern_fn)
    except OSError:
        sys.stderr.write("Error: failed to load pattern file\n")
        return 1
    minfo("main", f"Loaded {len(patterns)} patterns")

    minfo(
        "main",
        f"Searching for k-mers in FASTQ files (max edit distance: {max_e})...",
    )
    totals = [[0, 0] for _ in patterns]
    for fn in pos:
        minfo("main", f"Processing {fn}...")
        count_fastq(fn, patterns, max_e, totals, device)

    for i, p in enumerate(patterns):
        p.ref_count, p.alt_count = totals[i]

    minfo("main", "Writing VAF file...")
    avg_depth = write_vaf_file(out_fn, patterns)
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")
    return 0
