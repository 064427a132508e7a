"""Minimal BGZF (blocked gzip) reader with virtual-offset seeking (a
copy of kmer_tpu/io/bgzf.py).

The htslib-equivalent surface needed by BAM/BCF readers
(the reference's htslib/bgzf.c): BGZF files are concatenations of gzip
members, each at most 64 KiB of payload, carrying their compressed size
in a BC extra field.  Virtual offsets are (compressed_offset << 16) |
offset_within_decompressed_block, as used by .bai/.csi indexes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional


class BgzfReader:
    def __init__(self, path: str):
        self._fp = open(path, "rb")
        self._block_coffset = -1
        self._block: bytes = b""
        self._within = 0

    def close(self):
        self._fp.close()

    def _read_block_at(self, coffset: int) -> Optional[bytes]:
        """Read and inflate the BGZF block starting at coffset."""
        self._fp.seek(coffset)
        header = self._fp.read(18)
        if len(header) < 18:
            return None
        if header[0] != 0x1F or header[1] != 0x8B:
            raise ValueError(f"not a BGZF block at offset {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18] + self._fp.read(max(0, xlen - 6))
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC extra field")
        # total block = 12 (fixed header) + xlen + cdata + 8 (crc32+isize)
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fp.read(cdata_len)
        tail = self._fp.read(8)
        isize = struct.unpack("<I", tail[4:8])[0]
        out = zlib.decompress(cdata, -15)
        if len(out) != isize:
            raise ValueError("BGZF block ISIZE mismatch")
        self._block_coffset = coffset
        self._next_coffset = coffset + bsize
        return out

    def seek_voffset(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        if coffset != self._block_coffset:
            blk = self._read_block_at(coffset)
            if blk is None:
                # unreadable target (e.g. stale .bai pointing past EOF):
                # adopt the sought position with no successor so read()
                # returns empty and tell_voffset() reports THIS offset —
                # keeping the old block's coffset/next here would serve
                # bytes from an unrelated file region
                self._block = b""
                self._block_coffset = coffset
                self._next_coffset = None
            else:
                self._block = blk
        self._within = within

    def tell_voffset(self) -> int:
        return (self._block_coffset << 16) | self._within

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._block_coffset < 0:
                blk = self._read_block_at(0)
                if blk is None:
                    break
                self._block = blk
                self._within = 0
            avail = len(self._block) - self._within
            if avail <= 0:
                nxt = getattr(self, "_next_coffset", None)
                if nxt is None:
                    break
                blk = self._read_block_at(nxt)
                if blk is None or len(blk) == 0:
                    if blk is None:
                        break
                    # empty EOF block; keep going in case more follow
                    self._block = b""
                    self._within = 0
                    continue
                self._block = blk
                self._within = 0
                avail = len(self._block)
            take = min(avail, n)
            out += self._block[self._within : self._within + take]
            self._within += take
            n -= take
        return bytes(out)


def bgzf_write_blocks(fp, data: bytes, level: int = 6) -> None:
    """Write data as BGZF blocks (used by tests to build BAM fixtures)."""
    pos = 0
    while pos < len(data) or pos == 0:
        chunk = data[pos : pos + 0xFF00]
        pos += len(chunk)
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = 12 + 6 + len(cdata) + 8 - 1  # BSIZE = total size - 1
        fp.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff")
        fp.write(struct.pack("<H", 6))  # XLEN
        fp.write(b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize))
        fp.write(cdata)
        fp.write(struct.pack("<I", zlib.crc32(chunk) & 0xFFFFFFFF))
        fp.write(struct.pack("<I", len(chunk)))
        if pos >= len(data):
            break


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
