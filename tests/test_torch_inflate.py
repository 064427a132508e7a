"""The native reader's gzip decoder (kmer_tpu_torch/io/native/gzinflate.cpp)
against zlib's gzread itself, called through ctypes as the reader called
it before (gzopen, gzbuffer 1 MiB, gzread 1 MiB at a time): the text it
serves, and where it stops, on every form the reader meets, on damaged
streams and on cut ones."""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import random
import struct
import threading
import zlib

import pytest

from h100bench import gen
from kmer_tpu_torch.io import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native reader does not build here")

_rng = random.Random(24)


def _fasta(n: int, length: int = 100) -> bytes:
    return b"".join(b">r%09d\n%s\n" % (i, bytes(
        _rng.choice(b"ACGT") for _ in range(length))) for i in range(n))


_TEXT = _fasta(2000)
_BIG = _fasta(30_000)  # 3.3 MB: gzread's 2 MiB fetches and 1 MiB calls


def _deflate(data: bytes, level: int = 6,
             strategy: int = zlib.Z_DEFAULT_STRATEGY, every: int = 0,
             mode: int = zlib.Z_FULL_FLUSH) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    if not every:
        return c.compress(data) + c.flush()
    return b"".join(c.compress(data[i:i + every]) + c.flush(mode)
                    for i in range(0, len(data), every)) + c.flush()


def _trailer(data: bytes) -> bytes:
    return struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


_HEAD = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"


def _gz(data: bytes, **kw) -> bytes:
    return _HEAD + _deflate(data, **kw) + _trailer(data)


def _full_header(data: bytes) -> bytes:
    """A member whose header has FEXTRA, FNAME, FCOMMENT and FHCRC."""
    head = (b"\x1f\x8b\x08" + bytes([2 | 4 | 8 | 16]) + b"\x00" * 4
            + b"\x00\x03" + struct.pack("<H", 6) + b"AB\x02\x00xy"
            + b"reads.fa\x00" + b"a comment\x00")
    head += struct.pack("<H", zlib.crc32(head) & 0xFFFF)
    return head + _deflate(data) + _trailer(data)


def _generator_form(tmp_path) -> bytes:
    """h100bench.gen.write_gzip's form (level 1 pieces joined by full
    flushes), at a small size with 64 KiB pieces."""
    path = str(tmp_path / "gen.gz")
    old = gen._GZ_BLOCK
    gen._GZ_BLOCK = 1 << 16
    try:
        gen.write_gzip(path, [lambda i=i: _TEXT[i::3] for i in range(3)])
    finally:
        gen._GZ_BLOCK = old
    with open(path, "rb") as f:
        return f.read()


def _flip(data: bytes, at: int, bit: int = 0) -> bytes:
    b = bytearray(data)
    b[at] ^= 1 << bit
    return bytes(b)


def _flip_crc(member: bytes) -> bytes:
    return _flip(member, len(member) - 8)


def _gzread(path: str) -> bytes:
    z = ctypes.CDLL(ctypes.util.find_library("z") or "libz.so.1")
    z.gzopen.restype = ctypes.c_void_p
    z.gzopen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    z.gzbuffer.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    z.gzread.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint]
    z.gzclose.argtypes = [ctypes.c_void_p]
    fp = z.gzopen(os.fsencode(path), b"r")
    z.gzbuffer(fp, 1 << 20)
    buf = ctypes.create_string_buffer(1 << 20)
    out = []
    while True:
        n = z.gzread(fp, buf, 1 << 20)
        if n <= 0:
            break
        out.append(buf.raw[:n])
    z.gzclose(fp)
    return b"".join(out)


def _both(tmp_path, data: bytes, name: str = "in.gz"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    text, counters = native.read_text_native(path)
    return _gzread(path), text, counters


_gz6 = _gz(_TEXT)
_dyn_at = len(_HEAD) + 40  # inside the first dynamic block's codes

WHOLE = {
    "level0": lambda t: _gz(_TEXT, level=0),
    "level1": lambda t: _gz(_TEXT, level=1),
    "level6": lambda t: _gz6,
    "level9": lambda t: _gz(_TEXT, level=9),
    "fixed": lambda t: _gz(_TEXT, strategy=zlib.Z_FIXED),
    "stored_over_64k": lambda t: _gz(random.Random(1).randbytes(200_000),
                                     level=0),
    "match_258_at_32768": lambda t: _gz(
        random.Random(2).randbytes(32768) * 4 + b"A" * 70_000),
    "one_stream": lambda t: _gz(_BIG, level=1),
    "generator_form": _generator_form,
    "sync_flush": lambda t: _gz(_TEXT, level=1, every=7000,
                                mode=zlib.Z_SYNC_FLUSH),
    "multi_member": lambda t: (_gz(_TEXT[:5000], level=1) + _gz(b"")
                               + _gz(_TEXT[5000:], level=9)),
    "empty_member": lambda t: _gz(b""),
    "full_header": lambda t: _full_header(_TEXT),
    "plain": lambda t: _TEXT,
    "plain_one_byte": lambda t: b"\x1f",
    "empty_file": lambda t: b"",
    "trailing_garbage": lambda t: _gz6 + b"not gzip\n",
    "trailing_magic_garbage": lambda t: _gz6 + b"\x1f\x8b\x00junk",
    "flipped_crc": lambda t: _flip_crc(_gz6),
    "flipped_isize": lambda t: _flip(_gz6, len(_gz6) - 3, 5),
    "flipped_dynamic_block": lambda t: _flip(_gz6, _dyn_at, 3),
    "flipped_header_crc": lambda t: _flip(_full_header(_TEXT), 37),
    "big_flipped_crc": lambda t: _flip_crc(_gz(_BIG, level=1)),
    "second_member_2mib_flipped_crc": lambda t: (
        _gz(_BIG[:1_500_000]) + _flip_crc(_gz(_BIG[:2 << 20], level=1))),
}


@pytest.mark.parametrize("case", sorted(WHOLE))
def test_serves_what_gzread_serves(tmp_path, case):
    want, got, counters = _both(tmp_path, WHOLE[case](tmp_path))
    assert got == want
    assert counters["text_bytes"] == len(got)
    gz = case not in ("plain", "plain_one_byte", "empty_file")
    assert counters["inflate_bytes"] == (len(got) if gz else 0)


def _cuts(data: bytes, n: int):
    return sorted(set(range(0, 24)) | set(range(len(data) - 10, len(data)))
                  | set(range(0, len(data), max(1, len(data) // n))))


TRUNCATED = {
    "header_and_dynamic": lambda t: _full_header(_TEXT[:20_000]),
    "stored": lambda t: _gz(random.Random(3).randbytes(70_000), level=0),
    "fixed": lambda t: _gz(_TEXT[:20_000], strategy=zlib.Z_FIXED),
    "two_members": lambda t: (_gz(_TEXT[:9000], level=1)
                              + _gz(_TEXT[9000:20_000])),
}


@pytest.mark.parametrize("case", sorted(TRUNCATED))
def test_truncated_like_gzread(tmp_path, case):
    """Cut at a sweep of offsets: inside the header, the codes, a stored
    block, the trailer; every byte gzread serves, and no more."""
    data = TRUNCATED[case](tmp_path)
    for cut in _cuts(data, 40):
        want, got, _ = _both(tmp_path, data[:cut])
        assert got == want, cut


def test_random_damage_like_gzread(tmp_path):
    """Flipped bits anywhere in small and in multi-MiB members."""
    rng = random.Random(5)
    srcs = [_gz(_TEXT, level=1), _gz6,
            _gz(_BIG, level=1, every=1 << 20) + _gz(_TEXT)]
    for i in range(36):
        data = srcs[i % 3]
        data = _flip(data, rng.randrange(10, len(data)), rng.randrange(8))
        want, got, _ = _both(tmp_path, data)
        assert got == want, i


@pytest.mark.parametrize("gzipped", [True, False])
def test_fifo(tmp_path, gzipped):
    """A FIFO (`tool <(zcat ...)`): sniffed from its first read, with no
    reopen, in writes of a few KiB."""
    data = _gz(_BIG[:400_000], level=1) if gzipped else _BIG[:400_000]
    fifo = str(tmp_path / "fifo")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            for i in range(0, len(data), 5000):
                f.write(data[i:i + 5000])
                f.flush()

    t = threading.Thread(target=write)
    t.start()
    text, counters = native.read_text_native(fifo)
    t.join()
    assert text == _BIG[:400_000]
    assert counters["inflate_bytes"] == (len(text) if gzipped else 0)
