"""ctypes bindings for the native IO layer (after
kmer_tpu/io/native/__init__.py, over copies of its three sources and a
gzip decoder of its own): the FASTQ/FASTA block reader, in ASCII and
2-bit packed form, and its whole-record form (fastx_reader.cpp, over the
table-driven gzip/DEFLATE decoder of gzinflate.cpp, which serves the
bytes zlib's gzread serves), the sequential BAM scan of bam-vaf-counter
(bam_count.cpp) and the CRAM rANS 4x8 decoder (cram_rans.cpp).

The library builds with g++ at first use into build/kmer_tpu_torch/ at
the repository root (never beside the sources), named by a hash of the
sources and the flags, so a changed source builds anew.  Callers check
`available()` and use the pure-Python readers (io/fastx.py, io/bam.py,
io/cram.py) when it is False: no g++ or zlib, or KMER_TPU_NO_NATIVE set.

Each block call of the FASTQ/FASTA reader is a `reader.block` span
(utils/trace.py) under the count loop's span `parent`, with the deltas of
the reader's native counters (`ktp_stats`) over the call: `inflate_ns`
(the decoder, file reads included), `native_ns` (the whole call: the
decoder, the record scan and copy, the 2-bit pack), `inflate_bytes` (the
text bytes the DEFLATE decoder served) and `text_bytes` (all text bytes
served, a plain file's too).
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ...kernels._build import BUILD_DIR
from ...utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, name) for name in
         ("fastx_reader.cpp", "gzinflate.cpp", "bam_count.cpp",
          "cram_rans.cpp")]
_HDRS = [os.path.join(_HERE, "gzinflate.h")]
_lock = threading.Lock()
_lib = None
_tried = False


def _command(out: str):
    # No ISA flags beyond the platform baseline: the packing loop and the
    # decoder's fast loop and CRC carry their own target attributes and a
    # runtime CPU check.  zlib gives the decoder its byte-wise CRC32.
    return ["g++", "-O3", "-shared", "-fPIC", "-o", out, *_SRCS, "-lz"]


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_command("")).encode())
    for src in _SRCS + _HDRS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkmerio_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    try:
        r = subprocess.run(_command(tmp), capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, so)  # atomic publish: a concurrent build may race
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ktp_open.restype = ctypes.c_void_p
        lib.ktp_open.argtypes = [ctypes.c_char_p]
        lib.ktp_close.argtypes = [ctypes.c_void_p]
        lib.ktp_read_block.restype = ctypes.c_int64
        lib.ktp_read_block.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, i64p, i64p, i64p, i64p]
        lib.ktp_stats.restype = None
        lib.ktp_stats.argtypes = [ctypes.c_void_p, i64p]
        lib.ktp_read_text.restype = ctypes.c_int64
        lib.ktp_read_text.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
        lib.ktp_set_policy.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.ktp_read_block_packed.restype = ctypes.c_int64
        lib.ktp_read_block_packed.argtypes = [
            ctypes.c_void_p, u8p, u8p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, i64p, i64p, i64p, i64p]
        lib.ktp_read_records.restype = ctypes.c_int64
        lib.ktp_read_records.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p]
        lib.ktp_rans_decode.restype = ctypes.c_int32
        lib.ktp_rans_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                        ctypes.c_int64]
        lib.ktp_bam_count.restype = ctypes.c_int64
        lib.ktp_bam_count.argtypes = [
            ctypes.c_char_p, i32p, i32p, u8p, u8p, ctypes.c_int64, i64p,
            i64p]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("KMER_TPU_NO_NATIVE"):  # force pure-Python paths
        return False
    return _load() is not None


class _Counters:
    """A reader handle's ktp_stats, read after each block call: the
    deltas go into the call's `reader.block` span."""

    KEYS = ("inflate_ns", "native_ns", "inflate_bytes", "text_bytes")

    def __init__(self, lib, h):
        self.lib, self.h = lib, h
        self.now = np.zeros(len(self.KEYS), np.int64)
        self.ptr = self.now.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def into(self, sp) -> None:
        if not sp:
            return
        was = self.now.copy()
        self.lib.ktp_stats(self.h, self.ptr)
        sp.set(**dict(zip(self.KEYS, (self.now - was).tolist())))


def iter_packed_native(
    paths, k: int, block_bases: int, capacity: int, qual_policy=None,
    parent=trace.NULL,
) -> Iterator[Tuple[np.ndarray, int, int, int, Optional[int], bool]]:
    """Yield (ascii_u8[capacity], n_bytes_used, n_bases, n_seqs,
    row_bytes, batch_end) per buffer: n_bytes_used is the buffer layout
    boundary, n_bases/n_seqs are true per-read totals (a split read's
    halo is not counted again), row_bytes is L+1 when every packed read
    had length L, else None, and batch_end flags the end of one
    reference pipeline batch (yak-count.c:381-383).  qual_policy as in
    io.fastx.FastxReader; `parent`, the count loop's span."""
    lib = _load()
    assert lib is not None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for path in paths:
        h = lib.ktp_open(os.fsencode(path))
        if not h:
            raise OSError(errno.ENOENT, "cannot open", path)
        if qual_policy is not None:
            lib.ktp_set_policy(h, 1, block_bases, qual_policy[1],
                               qual_policy[2])
        try:
            stats = _Counters(lib, h)
            while True:
                buf = np.zeros(capacity, np.uint8)
                n_seqs, n_bases = ctypes.c_int64(), ctypes.c_int64()
                row_bytes, batch_end = ctypes.c_int64(), ctypes.c_int64()
                with trace.span("reader.block", parent) as sp:
                    used = lib.ktp_read_block(
                        h, buf.ctypes.data_as(u8p), capacity, k,
                        block_bases, ctypes.byref(n_seqs),
                        ctypes.byref(n_bases), ctypes.byref(row_bytes),
                        ctypes.byref(batch_end))
                    stats.into(sp)
                if used <= 0:
                    break
                yield (buf, int(used), int(n_bases.value),
                       int(n_seqs.value), int(row_bytes.value) or None,
                       bool(batch_end.value))
        finally:
            lib.ktp_close(h)


def iter_packed2bit_native(
    paths, k: int, block_bases: int, capacity: int, qual_policy=None,
    parent=trace.NULL,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, int, int, Optional[int],
                    bool]]:
    """Bit-packed form of iter_packed_native: yields (packed_u8[cap/4],
    mask_u8[cap/8], n_bytes_used, n_bases, n_seqs, row_bytes,
    batch_end).  Base 4i+m is the 2-bit code at bits 2m of packed[i];
    slot 8i+b is invalid (a separator, an N or past the packed region)
    when bit b of mask[i] is set.  n_bytes_used is the packed region's
    layout boundary (bases and separators of every piece); the other
    fields are iter_packed_native's.  capacity is rounded up to a
    multiple of 8."""
    lib = _load()
    assert lib is not None
    capacity = (capacity + 7) & ~7
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for path in paths:
        h = lib.ktp_open(os.fsencode(path))
        if not h:
            raise OSError(errno.ENOENT, "cannot open", path)
        if qual_policy is not None:
            lib.ktp_set_policy(h, 1, block_bases, qual_policy[1],
                               qual_policy[2])
        try:
            stats = _Counters(lib, h)
            while True:
                packed = np.zeros(capacity // 4, np.uint8)
                mask = np.zeros(capacity // 8, np.uint8)
                n_seqs, n_bases = ctypes.c_int64(), ctypes.c_int64()
                row_bytes, batch_end = ctypes.c_int64(), ctypes.c_int64()
                with trace.span("reader.block", parent) as sp:
                    used = lib.ktp_read_block_packed(
                        h, packed.ctypes.data_as(u8p),
                        mask.ctypes.data_as(u8p), capacity, k, block_bases,
                        ctypes.byref(n_seqs), ctypes.byref(n_bases),
                        ctypes.byref(row_bytes), ctypes.byref(batch_end))
                    stats.into(sp)
                if used <= 0:
                    break
                yield (packed, mask, int(used), int(n_bases.value),
                       int(n_seqs.value), int(row_bytes.value) or None,
                       bool(batch_end.value))
        finally:
            lib.ktp_close(h)


def read_text_native(path, chunk: int = 1 << 20):
    """(text, counters): the whole text of a file as the block reader
    scans it (gzinflate.cpp: gzip decoded, a plain file passed through,
    gzread's bytes on a damaged stream), and the reader's counters after
    it (_Counters.KEYS)."""
    lib = _load()
    assert lib is not None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h = lib.ktp_open(os.fsencode(path))
    if not h:
        raise OSError(errno.ENOENT, "cannot open", path)
    try:
        buf = np.empty(chunk, np.uint8)
        parts = []
        while True:
            n = lib.ktp_read_text(h, buf.ctypes.data_as(u8p), chunk)
            if n <= 0:
                break
            parts.append(buf[:n].tobytes())
        stats = _Counters(lib, h)
        lib.ktp_stats(h, stats.ptr)
        return b"".join(parts), dict(zip(stats.KEYS, stats.now.tolist()))
    finally:
        lib.ktp_close(h)


def iter_records_native(
    path, target_bases: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (bases_u8, lens_i64) per call of ktp_read_records over one
    file: whole records, every one (empty ones too) in file order, their
    raw bytes back to back and their lengths, about target_bases bases a
    call.  Each block is a view of buffers that the next one reuses.  A
    malformed quality section stops the stream (io.fastx.FastxReader's
    qual_policy=None)."""
    lib = _load()
    assert lib is not None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    h = lib.ktp_open(os.fsencode(path))
    if not h:
        raise OSError(errno.ENOENT, "cannot open", path)
    try:
        buf = np.empty(2 * target_bases, np.uint8)
        lens = np.empty(target_bases, np.int64)
        n = ctypes.c_int64()
        while True:
            used = lib.ktp_read_records(
                h, buf.ctypes.data_as(u8p), buf.size, target_bases,
                lens.size, lens.ctypes.data_as(i64p), ctypes.byref(n))
            if used < 0:  # a record longer than the buffer
                buf = np.empty(2 * -used, np.uint8)
                continue
            if n.value == 0:
                break
            yield buf[:used], lens[:n.value]
    finally:
        lib.ktp_close(h)


def bam_count_native(path, tids, starts, refs, alts):
    """Scan a BAM sequentially, counting ref/alt bases at SNP positions
    (bam_count.cpp; the Python loop of tools/bam_vaf_counter.py is its
    fallback).  tids/starts must be sorted by (tid, start); refs/alts
    are ASCII base codes.  Returns (ref_counts, alt_counts) int64
    arrays, or None when the native layer is unavailable or the header
    is unreadable as BAM.  A corrupt body gives the counts up to the
    damage, as the Python reader's stop at the first bad record does."""
    if not available():
        return None
    lib = _load()
    n = len(tids)
    tids = np.ascontiguousarray(tids, np.int32)
    starts = np.ascontiguousarray(starts, np.int32)
    refs = np.ascontiguousarray(refs, np.uint8)
    alts = np.ascontiguousarray(alts, np.uint8)
    ref_counts = np.zeros(n, np.int64)
    alt_counts = np.zeros(n, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ktp_bam_count(
        os.fsencode(path), tids.ctypes.data_as(i32p),
        starts.ctypes.data_as(i32p), refs.ctypes.data_as(u8p),
        alts.ctypes.data_as(u8p), n, ref_counts.ctypes.data_as(i64p),
        alt_counts.ctypes.data_as(i64p))
    if rc < 0:
        return None
    return ref_counts, alt_counts


def rans_decode_native(data: bytes, out_size: int):
    """rANS 4x8 decode (cram_rans.cpp); None when the native layer is
    unavailable or the stream is malformed, and io/cram.py then runs its
    Python decoder."""
    if not available():
        return None
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(out_size, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.ktp_rans_decode(src.ctypes.data_as(u8p), len(data),
                             out.ctypes.data_as(u8p), out_size)
    if rc != 0:
        return None
    return out.tobytes()
