"""Minimal CRAM 3.0 reader (a copy of kmer_tpu/io/cram.py) — the used
surface of htslib's cram/ for
bam-vaf-counter (the reference's bam-vaf-counter.c:24 accepts
SAM/BAM/CRAM transparently via htslib; SURVEY.md §2.2).

Decodes the containers/slices htslib 1.21 writes by default: gzip and
rANS-4x8 (order 0/1) block codecs, EXTERNAL / HUFFMAN / BETA /
BYTE_ARRAY_LEN / BYTE_ARRAY_STOP encodings, reference-based sequence
reconstruction from the substitution matrix + feature list (embedded
reference slices and verbatim-sequence records are handled too).  The
reference FASTA is resolved from the @SQ UR: field when present, else
a caller-provided path.  Output is CramRec objects exposing the same
surface BamRecord gives the CIGAR walk (flag/tid/pos/cigar/l_seq/
base_at/end_pos), so tools/bam_vaf_counter.py works unchanged.

Scope notes: .crai indexed access IS implemented (CraiIndex +
CramReader.query seek straight to the covering slices, reproducing
htslib's cram_range record filter — sam.c:1695, cram_decode.c:3475-3497);
without an index the tool falls back to the sequential scan, as the
reference does.  CRAM 3.1 default-profile codecs (rANS Nx16 and the
tok3 name tokenizer) are decoded via io/cram31.py; the small/archive
profile codecs (arith, fqzcomp) raise a clear error.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# varint + cursor helpers


class Cursor:
    __slots__ = ("d", "o")

    def __init__(self, data: bytes, off: int = 0):
        self.d = data
        self.o = off

    def u8(self) -> int:
        v = self.d[self.o]
        self.o += 1
        return v

    def take(self, n: int) -> bytes:
        v = self.d[self.o : self.o + n]
        self.o += n
        return v

    def itf8(self) -> int:
        d, o = self.d, self.o
        b0 = d[o]
        if b0 < 0x80:
            self.o = o + 1
            return b0
        if b0 < 0xC0:
            self.o = o + 2
            return ((b0 & 0x7F) << 8) | d[o + 1]
        if b0 < 0xE0:
            self.o = o + 3
            return ((b0 & 0x3F) << 16) | (d[o + 1] << 8) | d[o + 2]
        if b0 < 0xF0:
            self.o = o + 4
            return ((b0 & 0x1F) << 24) | (d[o + 1] << 16) | (d[o + 2] << 8) | d[o + 3]
        self.o = o + 5
        v = ((b0 & 0x0F) << 28) | (d[o + 1] << 20) | (d[o + 2] << 12) | (
            d[o + 3] << 4) | (d[o + 4] & 0x0F)
        # ITF8 is a 32-bit value; -1 encodes as 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        d, o = self.d, self.o
        b0 = d[o]
        n = 0
        for bit in (0x80, 0x40, 0x20, 0x10, 0x08, 0x04, 0x02, 0x01):
            if b0 & bit:
                n += 1
            else:
                break
        if n == 0:
            self.o = o + 1
            return b0
        if n < 8:
            v = b0 & ((1 << (7 - n)) - 1)
        else:
            v = 0
        for i in range(1, n + 1):
            v = (v << 8) | d[o + i]
        self.o = o + n + 1
        return v - (1 << 64) if v >= (1 << 63) else v


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("d", "pos")

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit position

    def bits(self, n: int) -> int:
        v = 0
        d, p = self.d, self.pos
        for _ in range(n):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 codec id 4)

_RANS_LOW = 1 << 23


def _rans_read_freqs(c: Cursor):
    """One frequency table in htslib's byte format (rANS_static.c
    rans_uncompress_O0 table loop): freq is 1 byte, or 2 bytes when the
    first has bit 7 set ((b&127)<<8 | next); symbols advance by explicit
    next-symbol bytes, with `sym+1` introducing an RLE run whose length
    byte covers the following consecutive symbols.  Terminates on
    symbol 0.  Frequencies sum to 4096 (TF_SHIFT 12)."""
    freq = [0] * 256
    j = c.u8()
    rle = 0
    while True:
        f = c.u8()
        if f >= 128:
            f = ((f & 127) << 8) | c.u8()
        freq[j] = f
        if rle:
            rle -= 1
            j += 1
        elif c.d[c.o] == j + 1:
            j = c.u8()
            rle = c.u8()
        else:
            j = c.u8()
        if j == 0:
            break
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freq[i]
    return freq, cum


def _rans_sym_lookup(freq, cum):
    """slot -> symbol lookup over the 4096-slot table."""
    lut = bytearray(4096)
    for s in range(256):
        f = freq[s]
        if f:
            lut[cum[s] : cum[s] + f] = bytes([s]) * f
    return bytes(lut)


def rans_decode(data: bytes, out_size: int) -> bytes:
    """rANS 4x8 decode (htslib rANS_static.c byte stream: order byte,
    compressed size u32, uncompressed size u32, then table + streams).
    Uses the native decoder (io/native/cram_rans.cpp) when buildable;
    this pure-Python twin is the fallback and the reference for tests."""
    from . import native

    nat = native.rans_decode_native(data, out_size)
    if nat is not None:
        return nat
    try:
        return _rans_decode_py(data, out_size)
    except (IndexError, KeyError, struct.error) as e:
        # every read/peek in the freq walk and the stream loop indexes
        # the raw buffer (and the order-1 loop keys per-context tables
        # by decoded symbols); a truncated or corrupt block must
        # surface as the descriptive error the callers document, not a
        # bare IndexError/KeyError traceback
        raise ValueError(
            f"truncated or corrupt rANS block ({len(data)} bytes, "
            f"expected {out_size} uncompressed)"
        ) from e


def _rans_decode_py(data: bytes, out_size: int) -> bytes:
    c = Cursor(data)
    order = c.u8()
    c.take(8)  # in/out sizes (trusted from the block header)
    out = bytearray(out_size)
    if order == 0:
        freq, cum = _rans_read_freqs(c)
        lut = _rans_sym_lookup(freq, cum)
        R = [0] * 4
        for j in range(4):
            R[j] = struct.unpack_from("<I", c.d, c.o)[0]
            c.o += 4
        d, o = c.d, c.o
        main = out_size & ~3
        for i in range(main):
            j = i & 3
            x = R[j]
            slot = x & 0xFFF
            s = lut[slot]
            out[i] = s
            x = (freq[s] * (x >> 12)) + slot - cum[s]
            while x < _RANS_LOW:
                x = (x << 8) | d[o]
                o += 1
            R[j] = x
        # tail: symbol lookup only, no state advance (rANS_static.c
        # rans_uncompress_O0 trailing switch)
        for j in range(out_size & 3):
            out[main + j] = lut[R[j] & 0xFFF]
        return bytes(out)
    if order == 1:
        # per-context frequency tables: ctx = previous byte, same
        # symbol/RLE walk one level up (rans_uncompress_O1)
        freqs: Dict[int, Tuple[list, list, bytes]] = {}
        i_sym = c.u8()
        rle_i = 0
        while True:
            f, cum = _rans_read_freqs(c)
            freqs[i_sym] = (f, cum, _rans_sym_lookup(f, cum))
            if rle_i:
                rle_i -= 1
                i_sym += 1
            elif c.d[c.o] == i_sym + 1:
                i_sym = c.u8()
                rle_i = c.u8()
            else:
                i_sym = c.u8()
            if i_sym == 0:
                break
        R = [0] * 4
        for j in range(4):
            R[j] = struct.unpack_from("<I", c.d, c.o)[0]
            c.o += 4
        d, o = c.d, c.o
        q = out_size >> 2
        ptrs = [0, q, 2 * q, 3 * q]
        last = [0, 0, 0, 0]
        for i in range(q):
            for j in range(4):
                f, cum, lut = freqs[last[j]]
                x = R[j]
                slot = x & 0xFFF
                s = lut[slot]
                out[ptrs[j] + i] = s
                x = (f[s] * (x >> 12)) + slot - cum[s]
                while x < _RANS_LOW:
                    x = (x << 8) | d[o]
                    o += 1
                R[j] = x
                last[j] = s
        for i in range(4 * q, out_size):  # tail on stream 3
            f, cum, lut = freqs[last[3]]
            x = R[3]
            slot = x & 0xFFF
            s = lut[slot]
            out[i] = s
            x = (f[s] * (x >> 12)) + slot - cum[s]
            while x < _RANS_LOW:
                x = (x << 8) | d[o]
                o += 1
            R[3] = x
            last[3] = s
        return bytes(out)
    raise ValueError(f"unsupported rANS order {order}")


def _decompress_block(method: int, data: bytes, raw_size: int) -> bytes:
    if method == 0:
        return data
    if method == 1:
        return zlib.decompress(data, 15 + 32)
    if method == 2:
        import bz2

        return bz2.decompress(data)
    if method == 3:
        import lzma

        return lzma.decompress(data)
    if method == 4:
        return rans_decode(data, raw_size)
    if method == 5:  # CRAM 3.1 rANS Nx16
        from .cram31 import rans_nx16_decode

        return rans_nx16_decode(data, raw_size)
    if method == 8:  # CRAM 3.1 name tokenizer
        from .cram31 import tok3_decode_names

        return tok3_decode_names(data, raw_size)
    if method == 6:  # CRAM 3.1 adaptive arithmetic coder
        from .cram_arith import arith_decode

        return arith_decode(data, raw_size)
    if method == 7:  # CRAM 3.1 fqzcomp quality codec
        from .cram_arith import fqz_decode

        return fqz_decode(data, raw_size)
    raise ValueError(f"unsupported CRAM block compression method {method}")


# ---------------------------------------------------------------------------
# structural parsing


class Block:
    __slots__ = ("method", "ctype", "content_id", "data")

    def __init__(self, c: Cursor):
        self.method = c.u8()
        self.ctype = c.u8()
        self.content_id = c.itf8()
        comp = c.itf8()
        raw = c.itf8()
        payload = c.take(comp)
        c.take(4)  # CRC32
        self.data = _decompress_block(self.method, payload, raw)


class Container:
    __slots__ = ("length", "ref_id", "start", "span", "n_records",
                 "n_blocks", "landmarks", "header_end")

    def __init__(self, c: Cursor):
        self.length = struct.unpack_from("<i", c.d, c.o)[0]
        c.o += 4
        self.ref_id = c.itf8()
        self.start = c.itf8()
        self.span = c.itf8()
        self.n_records = c.itf8()
        c.ltf8()  # record counter
        c.ltf8()  # bases
        self.n_blocks = c.itf8()
        self.landmarks = [c.itf8() for _ in range(c.itf8())]
        c.take(4)  # CRC32
        self.header_end = c.o


# ---------------------------------------------------------------------------
# encodings

E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6


class Encoding:
    """codec id + params; decode(core, ext) -> int, or byte-array forms."""

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        c = Cursor(params)
        if codec == E_EXTERNAL:
            self.cid = c.itf8()
        elif codec == E_HUFFMAN:
            n = c.itf8()
            self.alphabet = [c.itf8() for _ in range(n)]
            n2 = c.itf8()
            self.lengths = [c.itf8() for _ in range(n2)]
            self._build_huffman()
        elif codec == E_BETA:
            self.offset = c.itf8()
            self.nbits = c.itf8()
        elif codec == E_BYTE_ARRAY_LEN:
            lc = c.itf8()
            lp = c.take(c.itf8())
            vc = c.itf8()
            vp = c.take(c.itf8())
            self.len_enc = Encoding(lc, lp)
            self.val_enc = Encoding(vc, vp)
        elif codec == E_BYTE_ARRAY_STOP:
            self.stop = c.u8()
            self.cid = c.itf8()
        elif codec == E_NULL:
            pass
        else:
            raise ValueError(f"unsupported CRAM encoding codec {codec}")

    def _build_huffman(self):
        # canonical Huffman codes from (symbol, bit length) pairs
        pairs = sorted(zip(self.lengths, self.alphabet))
        self.codes = {}  # (length, code) -> symbol
        code, prev_len = 0, 0
        for ln, sym in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self.codes[(ln, code)] = sym
            code += 1
        self.const = pairs[0][1] if len(pairs) == 1 else None

    def read_int(self, core: BitReader, ext: Dict[int, Cursor]) -> int:
        if self.codec == E_EXTERNAL:
            return ext[self.cid].itf8()
        if self.codec == E_HUFFMAN:
            if self.const is not None:
                return self.const
            ln, code = 0, 0
            while True:
                code = (code << 1) | core.bits(1)
                ln += 1
                sym = self.codes.get((ln, code))
                if sym is not None:
                    return sym
                if ln > 31:
                    raise ValueError("bad huffman stream")
        if self.codec == E_BETA:
            return core.bits(self.nbits) - self.offset
        raise ValueError(f"codec {self.codec} cannot produce ints")

    def read_byte(self, core: BitReader, ext: Dict[int, Cursor]) -> int:
        if self.codec == E_EXTERNAL:
            return ext[self.cid].u8()
        return self.read_int(core, ext)

    def read_bytes(self, core: BitReader, ext: Dict[int, Cursor],
                   n: Optional[int] = None) -> bytes:
        if self.codec == E_BYTE_ARRAY_LEN:
            ln = self.len_enc.read_int(core, ext)
            v = self.val_enc
            if v.codec == E_EXTERNAL:
                return ext[v.cid].take(ln)
            return bytes(v.read_byte(core, ext) for _ in range(ln))
        if self.codec == E_BYTE_ARRAY_STOP:
            cur = ext[self.cid]
            end = cur.d.index(self.stop, cur.o)
            v = cur.d[cur.o : end]
            cur.o = end + 1
            return v
        if self.codec == E_EXTERNAL and n is not None:
            return ext[self.cid].take(n)
        raise ValueError(f"codec {self.codec} cannot produce byte arrays")


# ---------------------------------------------------------------------------
# compression header


class CompHeader:
    def __init__(self, data: bytes):
        c = Cursor(data)
        # preservation map
        c.itf8()  # size in bytes
        self.rn = self.ap_delta = self.rr = True
        self.sm = b"\x00" * 5
        self.td: List[List[Tuple[bytes, int]]] = [[]]
        for _ in range(c.itf8()):
            key = c.take(2)
            if key == b"RN":
                self.rn = bool(c.u8())
            elif key == b"AP":
                self.ap_delta = bool(c.u8())
            elif key == b"RR":
                self.rr = bool(c.u8())
            elif key == b"SM":
                self.sm = c.take(5)
            elif key == b"TD":
                blob = c.take(c.itf8())
                self.td = []
                for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                    tags = []
                    for i in range(0, len(line), 3):
                        tags.append((line[i : i + 2], line[i + 2]))
                    self.td.append(tags)
                if not self.td:
                    self.td = [[]]
            else:
                raise ValueError(f"unknown preservation key {key!r}")
        # data series encodings
        c.itf8()
        self.series: Dict[bytes, Encoding] = {}
        for _ in range(c.itf8()):
            key = c.take(2)
            codec = c.itf8()
            params = c.take(c.itf8())
            self.series[key] = Encoding(codec, params)
        # tag encodings
        c.itf8()
        self.tags: Dict[int, Encoding] = {}
        for _ in range(c.itf8()):
            key = c.itf8()
            codec = c.itf8()
            params = c.take(c.itf8())
            self.tags[key] = Encoding(codec, params)

    def dec(self, key: bytes) -> Encoding:
        e = self.series.get(key)
        if e is None:
            raise ValueError(f"data series {key!r} has no encoding")
        return e


# ---------------------------------------------------------------------------
# records

# BS code -> base, per reference base (substitution matrix, CRAM 3.0 §10.5)
_BASES = b"ACGTN"


def _subst_tables(sm: bytes):
    tables = []
    for ri in range(5):
        cands = [b for j, b in enumerate(_BASES) if j != ri]
        byte = sm[ri]
        by_code = [0] * 4
        for j, base in enumerate(cands):
            code = (byte >> (6 - 2 * j)) & 3
            by_code[code] = base
        tables.append(by_code)
    return tables


_NT_IDX = {65: 0, 67: 1, 71: 2, 84: 3, 78: 4}

FUNMAP = 4


class CramRec:
    __slots__ = ("flag", "tid", "pos", "mapq", "cigar", "seq", "l_seq")

    def __init__(self, flag, tid, pos, mapq, cigar, seq):
        self.flag = flag
        self.tid = tid
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar
        self.seq = seq
        self.l_seq = len(seq)

    def base_at(self, i: int) -> str:
        return chr(self.seq[i])

    def end_pos(self) -> int:
        e = self.pos
        for op, ln in self.cigar:
            if op in (0, 2, 3, 7, 8):
                e += ln
        return e if e > self.pos else self.pos + 1


class CraiIndex:
    """.crai — gzipped text, one line per slice:
    seq_id  align_start(1-based)  span  container_offset  slice_offset
    slice_len  (htslib cram/cram_index.c)."""

    def __init__(self, path: str):
        self.entries = []  # (seq_id, start1, span, c_off, s_off)
        try:
            with gzip.open(path, "rt") as f:
                for line in f:
                    t = line.split()
                    if len(t) < 6:
                        raise ValueError(f"{path}: malformed .crai line")
                    self.entries.append(
                        (int(t[0]), int(t[1]), int(t[2]), int(t[3]),
                         int(t[4]))
                    )
        except (OSError, gzip.BadGzipFile) as e:
            raise ValueError(f"{path}: not a .crai index") from e

    def slices_for(self, tid: int, beg1: int, end1: int):
        """Slices overlapping the 1-based inclusive [beg1, end1] on tid,
        in file order (the container filter of cram_decode.c:3137-3151)."""
        return [
            (c_off, s_off)
            for seq, start1, span, c_off, s_off in self.entries
            if seq == tid and start1 <= end1 and start1 + span - 1 >= beg1
        ]


class CramReader:
    """Sequential + .crai-indexed CRAM 3.0 reader over a whole file."""

    def __init__(self, path: str, reference: Optional[str] = None):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:4] != b"CRAM":
            raise ValueError("not a CRAM file")
        self.major, self.minor = self.data[4], self.data[5]
        if self.major != 3:
            raise ValueError(f"unsupported CRAM version {self.major}.{self.minor}")
        c = Cursor(self.data, 26)
        # first container: SAM header text
        cont = Container(c)
        blk = Block(c)
        hlen = struct.unpack_from("<i", blk.data, 0)[0]
        self.header_text = blk.data[4 : 4 + hlen].decode("latin-1")
        c.o = cont.header_end + cont.length
        self._body = c.o
        self.refs: List[str] = []
        self.name2tid: Dict[str, int] = {}
        self._ref_paths: List[Optional[str]] = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                name = ur = None
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("UR:"):
                        ur = f[3:]
                        if ur.startswith("file://"):
                            ur = ur[7:]
                self.name2tid[name] = len(self.refs)
                self.refs.append(name)
                self._ref_paths.append(ur)
        self._ref_seq: Dict[int, bytes] = {}
        self._fasta_path = reference
        self._fasta_cache: Optional[Dict[str, bytes]] = None
        self._cont_cache: Dict[int, Tuple[Container, CompHeader]] = {}
        self._slice_rec_cache: Dict[Tuple[int, int], list] = {}

    # -- indexed access ------------------------------------------------------

    def index_candidates(self, fn: str):
        return (fn + ".crai", os.path.splitext(fn)[0] + ".crai")

    def load_index(self, path: str) -> CraiIndex:
        return CraiIndex(path)

    def _container_at(self, off: int):
        got = self._cont_cache.get(off)
        if got is None:
            c = Cursor(self.data, off)
            cont = Container(c)
            comp = CompHeader(Block(c).data)
            got = self._cont_cache[off] = (cont, comp)
        return got

    def query(self, idx: CraiIndex, tid: int, beg: int, end: int):
        """Records overlapping 0-based [beg, end) on tid, via the .crai.

        Reproduces htslib's CRAM iterator exactly (sam.c:1695 builds the
        1-based range {tid, beg+1, end}; cram_decode.c:3475-3497 skips
        records with aend < start, stops at apos > end)."""
        beg1, end1 = beg + 1, end
        for c_off, s_off in idx.slices_for(tid, beg1, end1):
            for rec in self._slice_records(c_off, s_off):
                if rec.tid != tid:
                    continue
                if rec.pos + 1 > end1:  # apos > range.end: done
                    return
                if rec.end_pos() <= beg:  # aend < range.start: skip
                    continue
                yield rec

    def _slice_records(self, c_off: int, s_off: int):
        """Decoded records of one slice, cached — a dense SNP panel
        queries the same slice once per merged region (htslib keeps the
        current decoded slice alive the same way)."""
        key = (c_off, s_off)
        got = self._slice_rec_cache.get(key)
        if got is None:
            cont, comp = self._container_at(c_off)
            c = Cursor(self.data, cont.header_end + s_off)
            blk = Block(c)
            if blk.ctype != 2:
                raise ValueError("crai slice offset does not point at a "
                                 "slice header block")
            if len(self._slice_rec_cache) >= 4:  # keep a few hot slices
                self._slice_rec_cache.pop(next(iter(self._slice_rec_cache)))
            got = list(self._decode_slice(blk.data, c, comp, cont))
            self._slice_rec_cache[key] = got
        return got

    # -- reference resolution ------------------------------------------------

    def _load_fasta(self, path: str) -> Dict[str, bytes]:
        seqs: Dict[str, bytes] = {}
        op = gzip.open if path.endswith(".gz") else open
        name, parts = None, []
        with op(path, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    if name is not None:
                        seqs[name] = b"".join(parts)
                    name = line[1:].split()[0].decode("latin-1")
                    parts = []
                else:
                    parts.append(line.strip())
        if name is not None:
            seqs[name] = b"".join(parts)
        return seqs

    def ref_seq(self, tid: int) -> bytes:
        if tid in self._ref_seq:
            return self._ref_seq[tid]
        if self._fasta_cache is None:
            self._fasta_cache = {}
            self._fasta_loaded = set()
        for cand in ((self._fasta_path,) if self._fasta_path else ()) + (
            self._ref_paths[tid],
        ):
            if not cand or not os.path.exists(cand):
                continue
            # each @SQ may carry its own UR path: load every candidate
            # not yet merged into the cache before giving up
            if cand not in self._fasta_loaded:
                self._fasta_cache.update(self._load_fasta(cand))
                self._fasta_loaded.add(cand)
            seq = self._fasta_cache.get(self.refs[tid])
            if seq is not None:
                self._ref_seq[tid] = seq.upper()
                return self._ref_seq[tid]
        raise FileNotFoundError(
            f"CRAM reference for {self.refs[tid]} not found (tried UR "
            f"{self._ref_paths[tid]!r}); pass reference= to CramReader"
        )

    # -- record iteration ----------------------------------------------------

    def records(self):
        c = Cursor(self.data, self._body)
        n = len(self.data)
        while c.o < n:
            cont = Container(c)
            body_start = c.o
            if cont.ref_id == -1 and cont.start == 4542278 and cont.n_records == 0:
                break  # EOF container
            if cont.n_records == 0:
                c.o = body_start + cont.length
                continue
            comp = CompHeader(Block(c).data)
            while c.o < body_start + cont.length:
                blk = Block(c)
                if blk.ctype != 2:
                    continue  # skip stray blocks
                yield from self._decode_slice(blk.data, c, comp, cont)
            c.o = body_start + cont.length

    def _decode_slice(self, shdr: bytes, c: Cursor, comp: CompHeader,
                      cont: Container):
        sc = Cursor(shdr)
        s_ref = sc.itf8()
        s_start = sc.itf8()
        sc.itf8()  # span
        n_rec = sc.itf8()
        sc.ltf8()  # record counter
        n_blocks = sc.itf8()
        [sc.itf8() for _ in range(sc.itf8())]  # content ids
        embed_ref_id = sc.itf8()
        sc.take(16)  # MD5
        core: Optional[BitReader] = None
        ext: Dict[int, Cursor] = {}
        embedded_ref = None
        for _ in range(n_blocks):
            blk = Block(c)
            if blk.ctype == 5:
                core = BitReader(blk.data)
            elif blk.ctype == 4:
                ext[blk.content_id] = Cursor(blk.data)
                if blk.content_id == embed_ref_id:
                    embedded_ref = blk.data
        st = _subst_tables(comp.sm)

        def ref_bytes(tid, start0, ln):
            """ln reference bases at 0-based start0."""
            if embedded_ref is not None:
                off = start0 - (s_start - 1)
                return embedded_ref[off : off + ln]
            r = self.ref_seq(tid)
            return r[start0 : start0 + ln]

        d = comp.dec
        prev_ap = s_start  # AP delta baseline (1-based)
        for _ in range(n_rec):
            bf = d(b"BF").read_int(core, ext)
            cf = d(b"CF").read_int(core, ext)
            tid = s_ref
            if s_ref == -2:
                tid = d(b"RI").read_int(core, ext)
            rl = d(b"RL").read_int(core, ext)
            ap = d(b"AP").read_int(core, ext)
            if comp.ap_delta:
                ap = prev_ap + ap
                prev_ap = ap
            d(b"RG").read_int(core, ext)
            if comp.rn:
                d(b"RN").read_bytes(core, ext)
            if cf & 2:  # detached mate
                d(b"MF").read_int(core, ext)
                if not comp.rn:
                    d(b"RN").read_bytes(core, ext)
                d(b"NS").read_int(core, ext)
                d(b"NP").read_int(core, ext)
                d(b"TS").read_int(core, ext)
            elif cf & 4:  # mate downstream
                d(b"NF").read_int(core, ext)
            tl = d(b"TL").read_int(core, ext)
            for tag, ttype in comp.td[tl]:
                key = (tag[0] << 16) | (tag[1] << 8) | ttype
                self._skip_tag(comp.tags[key], core, ext)
            if not (bf & FUNMAP):
                rec = self._decode_mapped(bf, cf, tid, ap, rl, core, ext,
                                          d, st, ref_bytes)
            else:
                ba = d(b"BA")
                seq = bytes(ba.read_byte(core, ext) for _ in range(rl))
                if cf & 1:
                    qs = d(b"QS")
                    for _ in range(rl):
                        qs.read_byte(core, ext)
                rec = CramRec(bf, tid, ap - 1, 0, [], seq)
            yield rec

    @staticmethod
    def _skip_tag(enc: Encoding, core, ext):
        enc.read_bytes(core, ext)

    def _decode_mapped(self, bf, cf, tid, ap, rl, core, ext, d, st,
                       ref_bytes):
        fn = d(b"FN").read_int(core, ext)
        pos0 = ap - 1
        seq = bytearray(rl)
        cigar: List[Tuple[int, int]] = []
        read_i = 0  # read cursor (0-based)
        ref_i = pos0  # reference cursor (0-based)

        def add_op(op, ln):
            if ln <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))

        def copy_ref(ln):
            nonlocal read_i, ref_i
            if ln <= 0:
                return
            seq[read_i : read_i + ln] = ref_bytes(tid, ref_i, ln).upper()
            add_op(0, ln)  # M
            read_i += ln
            ref_i += ln

        fpos = 0  # 1-based read position of the current feature
        for _ in range(fn):
            fc = chr(d(b"FC").read_byte(core, ext))
            fpos += d(b"FP").read_int(core, ext)
            copy_ref(fpos - 1 - read_i)  # match gap before this feature
            if fc == "X":  # substitution
                code = d(b"BS").read_byte(core, ext)
                rb = ref_bytes(tid, ref_i, 1).upper()
                ri = _NT_IDX.get(rb[0] if rb else 78, 4)
                seq[read_i] = st[ri][code & 3]
                add_op(0, 1)
                read_i += 1
                ref_i += 1
            elif fc == "S":  # soft clip
                b = d(b"SC").read_bytes(core, ext)
                seq[read_i : read_i + len(b)] = b
                add_op(4, len(b))
                read_i += len(b)
            elif fc == "I":  # insertion
                b = d(b"IN").read_bytes(core, ext)
                seq[read_i : read_i + len(b)] = b
                add_op(1, len(b))
                read_i += len(b)
            elif fc == "i":  # single-base insertion
                seq[read_i] = d(b"BA").read_byte(core, ext)
                add_op(1, 1)
                read_i += 1
            elif fc == "D":  # deletion
                ln = d(b"DL").read_int(core, ext)
                add_op(2, ln)
                ref_i += ln
            elif fc == "N":  # ref skip
                ln = d(b"RS").read_int(core, ext)
                add_op(3, ln)
                ref_i += ln
            elif fc == "H":  # hard clip
                add_op(5, d(b"HC").read_int(core, ext))
            elif fc == "P":  # padding
                add_op(6, d(b"PD").read_int(core, ext))
            elif fc == "B":  # base + qual
                seq[read_i] = d(b"BA").read_byte(core, ext)
                d(b"QS").read_byte(core, ext)
                add_op(0, 1)
                read_i += 1
                ref_i += 1
            elif fc == "b":  # verbatim base run
                b = d(b"BB").read_bytes(core, ext)
                seq[read_i : read_i + len(b)] = b
                add_op(0, len(b))
                read_i += len(b)
                ref_i += len(b)
            elif fc == "q":  # qual run
                b = d(b"QQ").read_bytes(core, ext)
                read_i += 0  # quals only; read/ref cursors unaffected
            elif fc == "Q":  # single qual
                d(b"QS").read_byte(core, ext)
            else:
                raise ValueError(f"unknown CRAM feature code {fc!r}")
        copy_ref(rl - read_i)  # trailing match
        mq = d(b"MQ").read_int(core, ext)
        if cf & 1:
            qs = d(b"QS")
            for _ in range(rl):
                qs.read_byte(core, ext)
        return CramRec(bf, tid, pos0, mq, cigar, bytes(seq))

    def close(self):
        pass
