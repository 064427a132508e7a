"""ed-vaf-counter: VAF by approximate pattern search in reads (port of
kmer_tpu/tools/ed_vaf_counter.py).

For every read and every pattern, count the optimal end locations of
the ref and alt k-mers within edit distance -e (edlib's HW/LOC
semantics), then write the standard VAF file.  The search is the Myers
bit-vector scan (kernels/myers.py) on the default device, in batches of
reads by length bucket: on the card (default_device(): CUDA) the sum
entries of csrc/myers.cu, one launch a batch (and one more a batch for
patterns longer than 32 bases), each adding its batch's counts into
per-pattern int64 totals that stay on the card until the file ends;
with KMER_TPU_PLATFORM=cpu their plain torch versions.  A batch goes up
from one of two pinned staging buffers that take turns (each reused
after an event says its copy is done), and only its used width: its
longest read rounded up to 16 bases, the kernel's row stride.  The
batch loop makes no host synchronization, so the card scans one batch
while the host parses the next.

As in the JAX tool: the alphabet is the raw bytes of the patterns (no
case folding, N == N, every other read byte one never-match code); an
alt k-mer is truncated or NUL-padded to its ref k-mer's length; patterns
longer than 32 bases go through one multiword batch; an input that
cannot be opened is skipped with a warning.  Differences of form, which
change no count: a batch runs only its filled rows and used width (JAX
runs the bucket's static shape with the rest zero-length), the pattern
axis is not padded to a multiple of 128 lanes, and the totals are summed
on the device in int64 (see count_fastq).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import default_device
from ..io.fastx import FastxReader
from ..io.formats import read_patterns, write_vaf_file
from ..kernels.myers import (build_peq, build_peq_multiword, myers_hw_sums,
                             myers_hw_sums_multiword)
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


def _width(lens, nb: int) -> int:
    """A batch's used width: its longest read rounded up to 16 (at least
    16), the kernel's row stride (its 16-byte code loads)."""
    longest = int(lens[:nb].max()) if nb else 0
    return max(16, -(-longest // 16) * 16)


class _Staging:
    """Host -> device upload of a batch's used width.  On the card: two
    pinned buffers (codes, lengths) that take turns; before a buffer is
    refilled, the event recorded after its last copy is waited on (a
    copy two batches old, normally long done; `waits` counts the times it
    was not).  On the CPU: the arrays themselves."""

    def __init__(self, device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.slots = [None, None]
        self.turn = 0
        self.waits = 0

    def upload(self, codes, lens, nb: int):
        width = _width(lens, nb)
        if not self.pinned:
            return (torch.from_numpy(np.ascontiguousarray(codes[:nb, :width])),
                    torch.from_numpy(lens[:nb].copy()))
        slot = self.slots[self.turn]
        if slot is not None:
            if not slot[2].query():
                self.waits += 1
            slot[2].synchronize()
        if slot is None or slot[0].numel() < nb * width or \
                slot[1].numel() < nb:
            slot = (torch.empty(max(nb * width, codes.size), dtype=torch.uint8,
                                pin_memory=True),
                    torch.empty(codes.shape[0], dtype=torch.int32,
                                pin_memory=True),
                    torch.cuda.Event())
            self.slots[self.turn] = slot
        hc = slot[0][:nb * width].view(nb, width)
        hc.numpy()[:] = codes[:nb, :width]
        hl = slot[1][:nb]
        hl.numpy()[:] = lens[:nb]
        out = (hc.to(self.device, non_blocking=True),
               hl.to(self.device, non_blocking=True))
        slot[2].record()
        self.turn ^= 1
        return out


def _feed(reads, lut, flush):
    """Batch the reads by length bucket and flush every full batch, then
    every partial one: flush(codes, lens, nb) with the bucket's buffer
    (255 past each read's end) and its fill.  On the card this loop
    makes no host synchronization (chip_smoke.py phase 11 runs it under
    torch.cuda.set_sync_debug_mode("error"))."""
    batches = {}  # bucket -> [codes2d, lens, fill]
    for _name, seq in reads:
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
            flush(*batches.pop(bucket))
    for bucket in list(batches):
        flush(*batches.pop(bucket))


def count_fastq(fn, patterns, max_e, totals, device):
    """Accumulate per-pattern (ref, alt) counts over all reads in fn.

    The totals stay on the device, int64, for the whole file, and are
    read once after its last batch.  JAX sums a batch's counts in int32
    and accumulates those sums in int64 (kmer_tpu/tools/
    ed_vaf_counter.py:153); here every count goes straight into int64.
    The two agree whenever JAX's int32 batch sum does not wrap: a count
    is at most its read's length, which is at most the bucket, and a
    batch holds max(4, 2^21 // bucket) rows, so a batch's sum a pattern
    is at most max(2^21, 4 x bucket) < 2^31 for every read shorter than
    2^29 bases."""
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
        acc_long = torch.zeros(len(long_idx), dtype=torch.int64,
                               device=device)
    lp = max((len(x) for x in kmers if len(x) <= _KERNEL_MAX_PAT),
             default=1)
    # a long pattern's one-word lane is a dummy (the multiword batch
    # counts it): empty codes over lp bases
    pc, plen = _code_matrix(
        [b"" if len(x) > _KERNEL_MAX_PAT else x for x in kmers], lut, lp)
    plen[long_idx] = lp
    plen = torch.from_numpy(plen).to(device)
    peq = build_peq(torch.from_numpy(pc).to(device), plen, n_alpha)
    acc = torch.zeros(len(kmers), dtype=torch.int64, device=device)
    staging = _Staging(device)

    def flush(codes, lens, nb):
        if nb == 0:
            return
        codes, lens = staging.upload(codes, lens, nb)
        myers_hw_sums(peq, plen, codes, lens, max_e, acc)
        if long_idx:
            myers_hw_sums_multiword(peq_long, plenl, codes, lens, max_e,
                                    n_words, acc_long)

    _feed(FastxReader(fn), lut, flush)
    acc = acc.cpu().numpy()
    if long_idx:
        # the dummy lanes' sums give way to the multi-word batch's
        acc[long_idx] = acc_long.cpu().numpy()
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
