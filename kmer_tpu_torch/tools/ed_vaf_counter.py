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

The reads of a file come from the native reader where it is built and
the input is a path (io/native `iter_records_native`: whole records,
raw bytes, a few hundred KB a call); for `-` and without the native
reader from io/fastx.py `FastxReader`, joined into blocks of the same
size.  Each block is encoded and laid out into the bucket batches with
whole-array numpy operations (`_Batches`).

As in the JAX tool: the alphabet is the raw bytes of the patterns (no
case folding, N == N, every other read byte one never-match code); an
alt k-mer is truncated or NUL-padded to its ref k-mer's length; patterns
longer than 32 bases go through one multiword batch; an input that
cannot be opened is skipped with a warning.  Differences of form, which
change no count: a batch runs only its filled rows and used width (JAX
runs the bucket's static shape with the rest zero-length), the pattern
axis is not padded to a multiple of 128 lanes, and the totals are summed
on the device in int64 (see count_fastq).

Spans (utils/trace.py; none a read or a batch): `edvaf.patterns` (the
pattern file's load, the alphabet and the Peq build), `edvaf.file` (one
input file, from its open to its totals read back; counts `bases`,
`native_bases`, those of them that came through the native reader, and
`wait_ns`, the host's time blocked on a staging buffer's copy),
`edvaf.drain` (in it: the one read of the totals, where the host waits
for the card's backlog) and `edvaf.write` (the VAF file).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import default_device
from ..io import native
from ..io.fastx import FastxReader
from ..io.formats import read_patterns, write_vaf_file
from ..kernels.myers import (build_peq, build_peq_multiword, myers_hw_sums,
                             myers_hw_sums_multiword)
from ..utils import trace
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


def _buckets_for(lens: np.ndarray) -> np.ndarray:
    """_bucket_for(max(L, 1)) of every length."""
    b = np.full(len(lens), _MIN_BUCKET, np.int64)
    while True:
        short = b < lens
        if not short.any():
            return b
        b[short] *= 4


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
    was not, `wait_ns` the time they took).  On the CPU: the arrays
    themselves."""

    def __init__(self, device):
        self.device = device
        self.pinned = device.type == "cuda"
        self.slots = [None, None]
        self.turn = 0
        self.waits = 0
        self.wait_ns = 0  # host time blocked in those waits

    def upload(self, codes, lens, nb: int):
        width = _width(lens, nb)
        if not self.pinned:
            return (torch.from_numpy(np.ascontiguousarray(codes[:nb, :width])),
                    torch.from_numpy(lens[:nb].copy()))
        slot = self.slots[self.turn]
        if slot is not None and not slot[2].query():
            self.waits += 1
            t0 = time.perf_counter_ns()
            slot[2].synchronize()
            self.wait_ns += time.perf_counter_ns() - t0
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


def _fastx_blocks(reads, target_bases: int):
    """FastxReader's reads in the native reader's blocks: (raw bytes back
    to back, their lengths), about target_bases bases a block."""
    def block(seqs):
        return (np.frombuffer(b"".join(seqs), np.uint8),
                np.fromiter(map(len, seqs), np.int64, len(seqs)))

    seqs, size = [], 0
    for _name, seq in reads:
        seqs.append(seq)
        size += len(seq)
        if size >= target_bases:
            yield block(seqs)
            seqs, size = [], 0
    if seqs:
        yield block(seqs)


class _Batches:
    """Batch the reads by length bucket, a block of reads at a time: a
    bucket's reads go into its (rows, bucket) buffer in file order, a
    full buffer is flushed at once, flush(codes, lens, nb), and refilled,
    and close() flushes every partial one.  On the card the flushes make
    no host synchronization (chip_smoke.py phase 11 runs them under
    torch.cuda.set_sync_debug_mode("error")).  Each buffer keeps 255
    past each read's end: `hi` is the widest a row of it was written,
    and past `hi` it is still the fill it was made with."""

    def __init__(self, lut, flush):
        self.lut = lut
        self.flush = flush
        self.bufs = {}  # bucket -> [codes2d, lens, fill, hi]

    def add(self, raw: np.ndarray, lens: np.ndarray) -> None:
        """A block: its reads' raw bytes back to back, and their
        lengths.  Each bucket's reads become rows of their longest
        read's width, 255 past each read's end."""
        codes = np.take(self.lut, raw)
        lens = lens.astype(np.int32, copy=False)
        buckets = _buckets_for(lens)
        uniq = np.unique(buckets)
        for bucket in uniq:
            mine = buckets == bucket
            sub = lens[mine]
            width = int(sub.max())
            rows = np.full((len(sub), width), 255, np.uint8)
            rows[np.arange(width, dtype=np.int32) < sub[:, None]] = \
                codes if len(uniq) == 1 else codes[np.repeat(mine, lens)]
            self._place(int(bucket), rows, sub)

    def _place(self, bucket: int, rows: np.ndarray, lens) -> None:
        width = rows.shape[1]
        i = 0
        while i < len(rows):
            buf = self.bufs.get(bucket)
            if buf is None:
                n_rows = max(4, _BATCH_BYTES // bucket)
                buf = self.bufs[bucket] = [
                    np.full((n_rows, bucket), 255, np.uint8),
                    np.zeros(n_rows, np.int32), 0, 0]
            codes, blens, nb, hi = buf
            m = min(len(rows) - i, codes.shape[0] - nb)
            codes[nb:nb + m, :width] = rows[i:i + m]
            if hi > width:
                codes[nb:nb + m, width:hi] = 255
            blens[nb:nb + m] = lens[i:i + m]
            buf[2], buf[3] = nb + m, max(hi, width)
            i += m
            if buf[2] == codes.shape[0]:
                self.flush(codes, blens, buf[2])
                buf[2] = 0

    def close(self) -> None:
        for codes, blens, nb, _hi in self.bufs.values():
            if nb:
                self.flush(codes, blens, nb)
        self.bufs = {}


@dataclass
class _Search:
    """What each input file's scan searches for: the patterns' search
    strings (ref then alt a pattern), their alphabet, and their Peq
    tables on the device, the multi-word batch's for the strings longer
    than 32 bases (`long_idx`)."""
    n_kmers: int
    lut: np.ndarray
    peq: torch.Tensor
    plen: torch.Tensor
    long_idx: List[int]
    peq_long: Optional[torch.Tensor]
    plenl: Optional[torch.Tensor]
    n_words: int


def _search_tables(patterns, device) -> _Search:
    """The alphabet and the Peq tables of the patterns, built once a
    run (the JAX tool builds them again for each file: the same
    tables)."""
    kmers = _pattern_kmers(patterns)
    lut, n_alpha = _alphabet_lut(kmers)
    long_idx = [i for i, x in enumerate(kmers) if len(x) > _KERNEL_MAX_PAT]
    peq_long = plenl = None
    n_words = 0
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
    return _Search(len(kmers), lut, peq, plen, long_idx, peq_long, plenl,
                   n_words)


def count_fastq(fn, search: _Search, max_e, totals, device):
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
    s, long_idx = search, search.long_idx
    with trace.span("edvaf.file") as sp:
        acc = torch.zeros(s.n_kmers, dtype=torch.int64, device=device)
        if long_idx:
            acc_long = torch.zeros(len(long_idx), dtype=torch.int64,
                                   device=device)
        staging = _Staging(device)
        bases = [0]

        def flush(codes, lens, nb):
            if nb == 0:
                return
            if sp:  # the span's count, taken only while it records
                bases[0] += int(lens[:nb].sum())
            codes, lens = staging.upload(codes, lens, nb)
            myers_hw_sums(s.peq, s.plen, codes, lens, max_e, acc)
            if long_idx:
                myers_hw_sums_multiword(s.peq_long, s.plenl, codes, lens,
                                        max_e, s.n_words, acc_long)

        native_bases = 0
        on_native = fn != "-" and native.available()
        if on_native:
            blocks = native.iter_records_native(fn, _BATCH_BYTES // 8)
        else:
            blocks = _fastx_blocks(FastxReader(fn), _BATCH_BYTES // 8)
        batches = _Batches(s.lut, flush)
        for raw, lens in blocks:
            if sp and on_native:
                native_bases += raw.size
            batches.add(raw, lens)
        batches.close()
        with trace.span("edvaf.drain"):
            acc = acc.cpu().numpy()
            if long_idx:
                # the dummy lanes' sums give way to the multi-word batch's
                acc[long_idx] = acc_long.cpu().numpy()
        sp.set(bases=bases[0], native_bases=native_bases,
               wait_ns=staging.wait_ns)
    for i in range(len(totals)):
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
    with trace.span("edvaf.patterns"):
        try:
            patterns = read_patterns(pattern_fn)
        except OSError:
            sys.stderr.write("Error: failed to load pattern file\n")
            return 1
        search = _search_tables(patterns, device)
    minfo("main", f"Loaded {len(patterns)} patterns")

    minfo(
        "main",
        f"Searching for k-mers in FASTQ files (max edit distance: {max_e})...",
    )
    totals = [[0, 0] for _ in patterns]
    for fn in pos:
        minfo("main", f"Processing {fn}...")
        count_fastq(fn, search, max_e, totals, device)

    for i, p in enumerate(patterns):
        p.ref_count, p.alt_count = totals[i]

    minfo("main", "Writing VAF file...")
    with trace.span("edvaf.write"):
        avg_depth = write_vaf_file(out_fn, patterns)
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")
    return 0
