"""The native reader's gzip decoder (kmer_tpu_torch/io/native/gzinflate.cpp)
beside zlib's gzread and, where the host has it, libdeflate, on one CPU
thread: MB of text a second, best of --runs, each decoder over the same
bytes, in turns.

The inputs are the benchmark's reads (h100bench/gen.py: the mabs_k31
FASTA and a 150 bp FASTQ of its form) in the generator's own gzip form
(level 1, full flushes), and the same text as one level-1 stream with no
flush point.  They are made once into build/bench_inflate/ (page cache
warm when timed).

    python3 scripts/bench_inflate.py [--reads 1000000] [--runs 5]

Prints one line per input and decoder, then a JSON line of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import os
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100bench import gen  # noqa: E402
from kmer_tpu_torch.io import native  # noqa: E402

OUT = os.path.join(ROOT, "build", "bench_inflate")


def _inputs(n_reads: int):
    """{name: path}: each form's reads in the generator's gzip form, and
    as one stream."""
    os.makedirs(OUT, exist_ok=True)
    forms = {
        "fasta100": {"length": 100, "format": "fasta", "gc": 0.64},
        "fastq150": {"length": 150, "format": "fastq", "gc": 0.41},
    }
    paths = {}
    for name, f in forms.items():
        flushed = os.path.join(OUT, f"{name}_{n_reads}.gz")
        whole = os.path.join(OUT, f"{name}_{n_reads}_onestream.gz")
        if not (os.path.exists(flushed) and os.path.exists(whole)):
            cfg = {"reads": {"length": f["length"], "format": f["format"],
                             "substitution_rate": 0.005, "n_rate": 0.0001,
                             "reverse_strand_share": 0.5},
                   "gzip_level": 1}
            genome = gen.genome_codes((7, 1), 5_100_000, f["gc"])
            gen.write_reads(flushed, genome, n_reads, cfg, (7, 2))
            with open(flushed, "rb") as fh:
                text = zlib.decompress(fh.read(), 31)
            c = zlib.compressobj(1, zlib.DEFLATED, 31)
            with open(whole, "wb") as fh:
                fh.write(c.compress(text) + c.flush())
        paths[name] = flushed
        paths[name + "_onestream"] = whole
    return paths


def _zlib_gzread(path: str) -> int:
    z = ctypes.CDLL(ctypes.util.find_library("z") or "libz.so.1")
    z.gzopen.restype = ctypes.c_void_p
    z.gzopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    z.gzbuffer.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    z.gzread.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    z.gzclose.argtypes = [ctypes.c_void_p]
    buf = ctypes.create_string_buffer(1 << 20)
    fp = z.gzopen(os.fsencode(path), b"r")
    z.gzbuffer(fp, 1 << 20)  # the reader's settings before the decoder
    total = 0
    while True:
        n = z.gzread(fp, buf, 1 << 20)
        if n <= 0:
            break
        total += n
    z.gzclose(fp)
    return total


def _port(path: str) -> int:
    """The reader's text, 1 MiB a call into one buffer, as gzread's."""
    lib = native._load()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    buf = np.empty(1 << 20, np.uint8)
    h = lib.ktp_open(os.fsencode(path))
    total = 0
    while True:
        n = lib.ktp_read_text(h, buf.ctypes.data_as(u8p), buf.size)
        if n <= 0:
            break
        total += n
    lib.ktp_close(h)
    return total


def _cpu() -> dict:
    """The host's CPU flags the decoder picks paths by, and zlib's."""
    flags = set()
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("flags"):
                flags = set(line.split(":", 1)[1].split())
                break
    return {"cores": os.cpu_count(), "zlib": zlib.ZLIB_RUNTIME_VERSION,
            **{k: k in flags for k in ("pclmulqdq", "bmi2", "avx2")}}


def _libdeflate():
    name = ctypes.util.find_library("deflate")
    if not name:
        return None
    lib = ctypes.CDLL(name)
    lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
    lib.libdeflate_gzip_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    d = lib.libdeflate_alloc_decompressor()

    def run(path: str) -> int:  # one shot over the slurped file
        with open(path, "rb") as fh:
            comp = fh.read()
        size = int.from_bytes(comp[-4:], "little")
        out = np.empty(size + 64, np.uint8)
        got = ctypes.c_size_t()
        rc = lib.libdeflate_gzip_decompress(
            d, comp, len(comp), out.ctypes.data, out.size, ctypes.byref(got))
        assert rc == 0, rc
        return got.value

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    assert native.available(), "the native reader did not build"
    decoders = {"zlib_gzread": _zlib_gzread, "port": _port}
    ld = _libdeflate()
    if ld is not None:
        decoders["libdeflate"] = ld
    result = {"cpu": _cpu()}
    print(result["cpu"], flush=True)
    for name, path in _inputs(args.reads).items():
        comp = os.path.getsize(path)
        best = {k: float("inf") for k in decoders}
        size = None
        for _ in range(args.runs):
            for k, fn in decoders.items():
                t0 = time.perf_counter()
                n = fn(path)
                best[k] = min(best[k], time.perf_counter() - t0)
                assert size is None or n == size, (k, n, size)
                size = n
        row = {k: size / best[k] / 1e6 for k in decoders}
        with open(path, "rb") as fh:
            text = zlib.decompress(fh.read(), 31)
        t0 = time.perf_counter()
        zlib.crc32(text)
        row["zlib_crc32"] = size / (time.perf_counter() - t0) / 1e6
        result[name] = {"text_mb": size / 1e6, "gzip_mb": comp / 1e6,
                        "mb_per_s": row}
        print(name, f"{size / 1e6:.1f} MB text, {comp / size:.3f} B gzip/B:",
              ", ".join(f"{k} {v:.0f} MB/s" for k, v in row.items()),
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
