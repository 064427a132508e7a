"""ctypes bindings for the native FASTQ/FASTA reader (the FASTQ half of
kmer_tpu/io/native/__init__.py, over a copy of its fastx_reader.cpp).

The library builds with g++ at first use into build/kmer_tpu_torch/ at
the repository root (never beside the sources), named by a hash of the
source and the flags, so a changed source builds anew.  Callers check
`available()` and use the pure-Python reader (io/fastx.py) when it is
False: no g++ or zlib, or KMER_TPU_NO_NATIVE set.
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

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fastx_reader.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _command(out: str):
    # No ISA flags beyond the platform baseline: the packing loop carries
    # its own target("avx2") attribute and a runtime CPU check.
    # libdeflate (when present) decodes gzip faster than zlib; the reader
    # streams through zlib without it.
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", out, _SRC, "-lz"]
    if os.path.exists("/usr/include/libdeflate.h"):
        cmd.insert(1, "-DKTP_HAVE_LIBDEFLATE")
        cmd.append("-ldeflate")
    return cmd


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_command("")).encode())
    with open(_SRC, "rb") as f:
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
        lib.ktp_open.restype = ctypes.c_void_p
        lib.ktp_open.argtypes = [ctypes.c_char_p]
        lib.ktp_close.argtypes = [ctypes.c_void_p]
        lib.ktp_read_block.restype = ctypes.c_int64
        lib.ktp_read_block.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64, i64p, i64p, i64p, i64p]
        lib.ktp_set_policy.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("KMER_TPU_NO_NATIVE"):  # force pure-Python paths
        return False
    return _load() is not None


def iter_packed_native(
    paths, k: int, block_bases: int, capacity: int, qual_policy=None
) -> Iterator[Tuple[np.ndarray, int, int, int, Optional[int], bool]]:
    """Yield (ascii_u8[capacity], n_bytes_used, n_bases, n_seqs,
    row_bytes, batch_end) per buffer: n_bytes_used is the buffer layout
    boundary, n_bases/n_seqs are true per-read totals (a split read's
    halo is not counted again), row_bytes is L+1 when every packed read
    had length L, else None, and batch_end flags the end of one
    reference pipeline batch (yak-count.c:381-383).  qual_policy as in
    io.fastx.FastxReader."""
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
            while True:
                buf = np.zeros(capacity, np.uint8)
                n_seqs, n_bases = ctypes.c_int64(), ctypes.c_int64()
                row_bytes, batch_end = ctypes.c_int64(), ctypes.c_int64()
                used = lib.ktp_read_block(
                    h, buf.ctypes.data_as(u8p), capacity, k, block_bases,
                    ctypes.byref(n_seqs), ctypes.byref(n_bases),
                    ctypes.byref(row_bytes), ctypes.byref(batch_end))
                if used <= 0:
                    break
                yield (buf, int(used), int(n_bases.value),
                       int(n_seqs.value), int(row_bytes.value) or None,
                       bool(batch_end.value))
        finally:
            lib.ktp_close(h)
