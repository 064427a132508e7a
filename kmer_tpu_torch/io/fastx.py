"""Streaming FASTA/FASTQ reader — the kseq.h equivalent (a copy of
kmer_tpu/io/fastx.py, the part the port calls: `read_blocks`, `Block`
and the reader behind them; the port imports nothing of kmer_tpu).

Handles plain or gzipped input, multi-line FASTA, 4-line FASTQ with `+`
separator and quality lines, and `@`/`>` headers, mirroring the kseq
state machine (the reference's kseq.h:187-232).  Returns sequences as
raw bytes; quality is parsed (to advance the stream) but not retained —
no reference tool uses qualities.

Reading is chunk-buffered (1 MiB) with an integer cursor into the
buffer (compacted once per refill — per-line tail re-slicing was
O(chunk^2)); for higher throughput the C++ reader slots in behind the
same Block interface (see io/native).
"""

from __future__ import annotations

import io
import os
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

_CHUNK = 1 << 20


class _GzipStream:
    """gzread-equivalent gzip reader: multi-member, and damaged or
    truncated streams yield their readable prefix then EOF instead of
    raising (the reference reads through zlib's gzread, which does the
    same — gzip.GzipFile would discard the prefix and raise)."""

    def __init__(self, fileobj):
        self._f = fileobj
        self._z = zlib.decompressobj(16 + zlib.MAX_WBITS)
        self._pending = b""
        self._done = False

    def _decompress(self, raw: bytes) -> bytes:
        out = []
        while raw:
            try:
                out.append(self._z.decompress(raw))
            except zlib.error:
                self._done = True
                break
            if self._z.eof:  # next gzip member (bgzf/pigz outputs)
                raw = self._z.unused_data
                self._z = zlib.decompressobj(16 + zlib.MAX_WBITS)
            else:
                raw = b""
        return b"".join(out)

    def read(self, n: int) -> bytes:
        while len(self._pending) < n and not self._done:
            raw = self._f.read(1 << 16)
            if not raw:
                self._done = True
                break
            self._pending += self._decompress(raw)
        out, self._pending = self._pending[:n], self._pending[n:]
        return out

    def close(self):
        self._f.close()


def _open_maybe_gz(path: str):
    if path == "-":
        # honor a replaced sys.stdin (tests) and sniff gzip like kseq
        # over gzread does (the reference's kc-py1.py reads plain stdin,
        # but gzip -dc | tool and tool <(...) both work either way)
        import sys

        raw = getattr(sys.stdin, "buffer", None)
        if raw is None:
            raw = os.fdopen(os.dup(0), "rb", closefd=True)
        f = raw if hasattr(raw, "peek") else io.BufferedReader(raw)
        if f.peek(2)[:2] == b"\x1f\x8b":
            return _GzipStream(f)
        return f
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        f.seek(0)
        return _GzipStream(f)
    f.seek(0)
    return f


class FastxReader:
    """Iterates (name, seq_bytes) records from FASTA or FASTQ.

    qual_policy controls what a malformed quality section (kseq's -2:
    quality length != sequence length, or EOF inside quality) does —
    the reference tools genuinely differ here:

      None                  stop the stream for good, dropping the bad
                            record (kc-c1/c2, ed-vaf-counter,
                            snp-pattern-gen: `while (kseq_read >= 0)`)
      ("resume", min_len, workers)
                            drop the bad record and keep reading.  A -2
                            arriving while the reference's current read
                            block is still empty makes its step 0 return
                            NULL — which retires ONE kt_pipeline worker
                            (kthread.c:120: only that worker exits) —
                            so the stream survives `workers` such events
                            before stopping (kc-c3: 2, kc-c4/yak/vaf:
                            3).  The virtual block fills with len(seq)
                            per record of length >= min_len (kc-c3
                            counts all reads: min_len 0; kc-c4/yak/vaf
                            skip reads < k first) and resets at
                            ref_block bases (the tool's -b/-K value).
    """

    def __init__(self, path: str, qual_policy=None, ref_block: int = 0):
        self._fp = _open_maybe_gz(path)
        self._buf = b""
        self._pos = 0  # integer cursor into _buf (compacted on refill)
        self._eof = False
        self._qual_policy = qual_policy
        self._ref_block = ref_block
        self._ref_sum = 0
        self._nulls = 0

    def close(self):
        self._fp.close()

    def _fill(self) -> bool:
        try:
            chunk = self._fp.read(_CHUNK)
        except EOFError:
            # truncated gzip stream: zlib's gzread (the reference's
            # reader, kseq over gzread) silently yields the readable
            # prefix and stops; match that instead of raising
            chunk = b""
        if not chunk:
            self._eof = True
            return False
        if self._pos:
            # compact ONCE per refill — re-slicing the tail per line
            # made the reader O(chunk^2): 0.6 MB/s measured on 100 bp
            # FASTQ, and this is the mandatory stdin path
            self._buf = self._buf[self._pos:]
            self._pos = 0
        self._buf += chunk
        return True

    def _readline(self) -> Optional[bytes]:
        while True:
            nl = self._buf.find(b"\n", self._pos)
            if nl >= 0:
                line = self._buf[self._pos:nl]
                self._pos = nl + 1
                if line.endswith(b"\r"):
                    line = line[:-1]
                return line
            if not self._fill():
                if self._pos < len(self._buf):
                    line = self._buf[self._pos:]
                    self._buf, self._pos = b"", 0
                    return line
                return None

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        line = self._readline()
        while True:
            # skip junk until a header — kseq does this before EVERY
            # record (kseq.h:198), not just at file start
            while line is not None and not line.startswith((b">", b"@")):
                line = self._readline()
            if line is None:
                return
            name = line[1:].split(b" ", 1)[0].split(b"\t", 1)[0]
            seq_parts: List[bytes] = []
            line = self._readline()
            while line is not None and not line.startswith((b">", b"@", b"+")):
                if line:
                    seq_parts.append(line)
                line = self._readline()
            seq = b"".join(seq_parts)
            if line is not None and line.startswith(b"+"):
                # a '+' line starts the quality section REGARDLESS of the
                # record's header char — kseq checks only c == '+'
                # (kseq.h:222 `if (c != '+') return`), even for '>' FASTA.
                # Quality lines are consumed blindly until their length
                # reaches the sequence's; a mismatch (overshoot or EOF)
                # is kseq's -2 — handled per qual_policy (see __init__).
                need = len(seq)
                bad = False
                # kseq ALWAYS consumes at least one quality line (the
                # getuntil2 call executes before the length check,
                # kseq.h:229) — so an empty sequence with a non-empty
                # quality line is still a -2
                ql = self._readline()
                if ql is None:
                    got = 0  # EOF: kseq's loop exits with qual.l = 0
                else:
                    got = len(ql)
                    while got < need:
                        ql = self._readline()
                        if ql is None:
                            bad = True  # no/short quality at EOF
                            break
                        got += len(ql)
                if got != need:
                    bad = True  # quality length mismatch
                if bad:
                    if self._qual_policy is None:
                        return
                    if self._ref_sum == 0:
                        # empty reference block: its step 0 returns NULL,
                        # retiring one pipeline worker
                        self._nulls += 1
                        if self._nulls >= self._qual_policy[2]:
                            return
                    # flush-and-resume: the reference's partial block was
                    # processed; reading restarts with an empty block
                    self._ref_sum = 0
                    line = self._readline()
                    while line is not None and not line.startswith(
                        (b">", b"@")
                    ):
                        line = self._readline()
                    continue
                line = self._readline()
            if self._qual_policy is not None:
                if len(seq) >= self._qual_policy[1]:
                    self._ref_sum += len(seq)
                if self._ref_block and self._ref_sum >= self._ref_block:
                    self._ref_sum = 0
            yield name, seq


@dataclass
class Block:
    """A packed block of reads: kc-c4 pipeline step-0 output
    (the reference's kc-c4.c:133-155)."""

    seqs: List[bytes]
    sum_len: int
    n_kmers: int  # sum of (len - k + 1) over reads with len >= k


def read_blocks(
    paths: Sequence[str], k: int, block_len: int, min_len_filter: bool = True,
    qual_policy=None,
) -> Iterator[Block]:
    """Yield blocks of ~block_len total bases (reads shorter than k are
    skipped when min_len_filter, matching kc-c4.c:140).  qual_policy is
    the malformed-quality behavior, see FastxReader."""
    for path in paths:
        reader = FastxReader(path, qual_policy=qual_policy,
                             ref_block=block_len)
        blk = Block([], 0, 0)
        for _, seq in reader:
            if min_len_filter and len(seq) < k:
                continue
            blk.seqs.append(seq)
            blk.sum_len += len(seq)
            if len(seq) >= k:
                blk.n_kmers += len(seq) - k + 1
            if blk.sum_len >= block_len:
                yield blk
                blk = Block([], 0, 0)
        if blk.sum_len:
            yield blk
        reader.close()
