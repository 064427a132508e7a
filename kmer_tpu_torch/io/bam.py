"""Minimal BAM reader + .bai index queries (a copy of kmer_tpu/io/bam.py)
— the htslib surface used by
bam-vaf-counter (the reference's bam-vaf-counter.c:24-25): header name->tid,
sequential record reads, and indexed region iteration (sam_itr_queryi).

Formats per the SAM/BAM spec (as implemented in htslib sam.c / index.c):
BAM records over BGZF; .bai = 5-level binning index (bin sizes 16 kb ..
512 Mb) + 16 kb linear index.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

from .bgzf import BgzfReader

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"

# flags (sam.h)
FUNMAP = 0x4
FQCFAIL = 0x200
FDUP = 0x400

CIGAR_OPS = "MIDNSHP=X"


# 256-entry nybble-pair -> 2-char decode table (vectorizes full-SEQ decode)
_NYB2PAIR = [SEQ_NT16_STR[b >> 4] + SEQ_NT16_STR[b & 0xF] for b in range(256)]


class BamRecord:
    """One alignment record.  CIGAR and SEQ decode lazily: the hot
    consumer (bam-vaf-counter's sequential scan) discards most records
    after the tid/flag check, so the per-base nybble decode must not run
    for them (mirrors htslib handing out the raw bam1_t)."""

    __slots__ = ("tid", "pos", "flag", "_cigar", "_cigar_raw", "l_seq",
                 "_nyb", "_seq")

    def __init__(self, tid, pos, flag, cigar=None, seq=None,
                 cigar_raw=None, nyb=None, l_seq=None):
        self.tid = tid
        self.pos = pos
        self.flag = flag
        self._cigar = cigar
        self._cigar_raw = cigar_raw
        self._seq = seq
        self._nyb = nyb
        self.l_seq = len(seq) if seq is not None else (l_seq or 0)

    @property
    def cigar(self) -> List[Tuple[int, int]]:
        """[(op, len)]; op indexes CIGAR_OPS."""
        if self._cigar is None:
            raw = self._cigar_raw
            words = struct.unpack(f"<{len(raw) // 4}I", raw)
            self._cigar = [(v & 0xF, v >> 4) for v in words]
        return self._cigar

    @property
    def seq(self) -> str:
        if self._seq is None:
            self._seq = "".join(
                map(_NYB2PAIR.__getitem__, self._nyb)
            )[: self.l_seq]
        return self._seq

    def base_at(self, i: int) -> str:
        """Single base without decoding the whole SEQ."""
        if self._seq is not None:
            return self._seq[i]
        b = self._nyb[i >> 1]
        return SEQ_NT16_STR[(b >> 4) if i & 1 == 0 else (b & 0xF)]

    def end_pos(self) -> int:
        """bam_endpos: pos + reference-consumed length (M/D/N/=/X)."""
        ref_len = 0
        for op, ln in self.cigar:
            if op in (0, 2, 3, 7, 8):
                ref_len += ln
        return self.pos + max(ref_len, 1)


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode("latin-1")
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            self.ref_names.append(name)
            self.ref_lens.append(l_ref)
        self.name2tid: Dict[str, int] = {n: i for i, n in enumerate(self.ref_names)}
        self._body_voffset = self._bgzf.tell_voffset()

    def close(self):
        self._bgzf.close()

    def index_candidates(self, fn: str):
        """htslib's local-index search order (hts_idx_check_local,
        hts.c:4745-4760): fn.bam.csi, fn.csi, then fn.bam.bai,
        fn.bai."""
        import os

        stem = os.path.splitext(fn)[0]
        return (fn + ".csi", stem + ".csi", fn + ".bai", stem + ".bai")

    def load_index(self, path: str):
        return load_bam_index(path)

    def _read_record(self) -> Optional[BamRecord]:
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        block_size = struct.unpack("<i", raw)[0]
        if block_size < 32:
            # corrupt record body: stop at the first bad record, like
            # the native scanner (io/native/bam_count.cpp block_size
            # guard) — a struct.error traceback here would make the
            # tool's output depend on whether the native path was used
            return None
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            return None
        (
            ref_id,
            pos,
            l_read_name,
            _mapq,
            _bin,
            n_cigar,
            flag,
            l_seq,
            _next_ref,
            _next_pos,
            _tlen,
        ) = struct.unpack("<iiBBHHHiiii", data[:32])
        off = 32 + l_read_name
        cigar_raw = data[off : off + 4 * n_cigar]
        off += 4 * n_cigar
        nybbles = data[off : off + (l_seq + 1) // 2]
        return BamRecord(ref_id, pos, flag, cigar_raw=cigar_raw,
                         nyb=nybbles, l_seq=l_seq)

    def records(self) -> Iterator[BamRecord]:
        """Sequential scan of all records (sam_read1 fallback path)."""
        self._bgzf.seek_voffset(self._body_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    def query(self, index: "BaiIndex", tid: int, beg: int, end: int) -> Iterator[BamRecord]:
        """Records overlapping [beg, end) on tid (sam_itr_queryi/next)."""
        chunks = index.chunks_for(tid, beg, end)
        for cbeg, cend in chunks:
            self._bgzf.seek_voffset(cbeg)
            while self._bgzf.tell_voffset() < cend:
                rec = self._read_record()
                if rec is None:
                    return
                if rec.tid != tid or rec.pos >= end:
                    break
                if rec.end_pos() > beg:
                    yield rec


def _reg2bins(beg: int, end: int) -> List[int]:
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def _merge_chunks(chunks: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort + merge overlapping/adjacent chunk ranges (the off[] merge
    in hts_itr_query, hts.c:3700-3712)."""
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            if ce > merged[-1][1]:
                merged[-1] = (merged[-1][0], ce)
        else:
            merged.append((cb, ce))
    return merged


def load_bam_index(path: str):
    """CsiIndex or BaiIndex by content: .bai is raw ("BAI\\1" magic),
    .csi is BGZF-wrapped (gzip magic) — the idx_read format sniff
    (hts.c:2937-2967)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"BAI\x01":
        return BaiIndex(path)
    if magic[:2] == b"\x1f\x8b":
        return CsiIndex(path)
    raise ValueError(f"{path}: not a BAI or CSI index")


class CsiIndex:
    """CSI\\1 binning index (idx_read, hts.c:2948-2967; core
    2872-2935): BGZF-wrapped; binning parameterized by
    (min_shift, depth) and each bin carries loff — the virtual offset
    of the first overlapping record — in place of .bai's 16 kb linear
    index."""

    def __init__(self, path: str):
        r = BgzfReader(path)
        try:
            parts = []
            while True:
                b = r.read(1 << 20)
                if not b:
                    break
                parts.append(b)
        finally:
            r.close()
        data = b"".join(parts)
        if data[:4] != b"CSI\x01":
            raise ValueError(f"{path}: not a CSI index")
        self.min_shift, self.depth, l_aux = struct.unpack_from(
            "<iii", data, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        # per ref: bin id -> (loff, [(chunk_beg, chunk_end)])
        self.bins: List[Dict[int, Tuple[int, List[Tuple[int, int]]]]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {}
            for _ in range(n_bin):
                bin_id, loff, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bd[bin_id] = (loff, chunks)
            self.bins.append(bd)

    def _min_offset(self, bd, beg: int) -> int:
        """loff of the smallest extant bin covering beg, walking to the
        previous sibling / up to the parent when absent
        (hts_itr_query's min_off computation, hts.c:3434-3446)."""
        b = ((1 << 3 * self.depth) - 1) // 7 + (beg >> self.min_shift)
        while True:
            if b in bd:
                return bd[b][0]
            if b == 0:
                return 0
            parent = (b - 1) >> 3
            first = (parent << 3) + 1
            b = b - 1 if b > first else parent

    def chunks_for(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if tid < 0 or tid >= len(self.bins):
            return []
        bd = self.bins[tid]
        if not bd:
            return []
        max_s = self.min_shift + 3 * self.depth
        if end > (1 << max_s):
            end = 1 << max_s
        if beg < 0:
            beg = 0
        if beg >= end:
            return []
        min_off = self._min_offset(bd, beg)
        chunks: List[Tuple[int, int]] = []
        # generalized reg2bins (reg2bins_narrow, hts.c:3094-3109)
        s, t = max_s, 0
        for level in range(self.depth + 1):
            for b in range(t + (beg >> s), t + ((end - 1) >> s) + 1):
                loff_chunks = bd.get(b)
                if loff_chunks is None:
                    continue
                for cb, ce in loff_chunks[1]:
                    if ce > min_off:
                        chunks.append((max(cb, min_off), ce))
            s -= 3
            t += 1 << (3 * level)
        return _merge_chunks(chunks)


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.intervals: List[List[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bd[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.bins.append(bd)
            self.intervals.append(ioff)

    def chunks_for(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if tid < 0 or tid >= len(self.bins):
            return []
        bd = self.bins[tid]
        ivs = self.intervals[tid]
        min_off = 0
        iv = beg >> 14
        if iv < len(ivs):
            min_off = ivs[iv]
        chunks = []
        for b in _reg2bins(beg, end):
            for cb, ce in bd.get(b, []):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        return _merge_chunks(chunks)


_CIGAR_CODE = {c: i for i, c in enumerate("MIDNSHP=X")}


class SamTextReader:
    """Plain-text SAM reader exposing the BamReader record interface
    (the reference accepts SAM transparently via htslib sam_open,
    the reference's bam-vaf-counter.c:497; CRAM is out of scope)."""

    def __init__(self, path: str):
        import gzip as _gzip

        self.path = path
        f = open(path, "rb")
        if f.peek(2)[:2] == b"\x1f\x8b":
            f.seek(0)
            f = _gzip.GzipFile(fileobj=f)
        self._fp = f
        self.ref_names: List[str] = []
        self.ref_lens: List[int] = []
        self.header_text = ""
        self._pending: Optional[bytes] = None
        header_lines = []
        for line in self._fp:
            if line.startswith(b"@"):
                header_lines.append(line.decode(errors="replace"))
                if line.startswith(b"@SQ"):
                    name, ln = None, 0
                    for fld in line.rstrip(b"\r\n").split(b"\t")[1:]:
                        if fld.startswith(b"SN:"):
                            name = fld[3:].decode("latin-1")
                        elif fld.startswith(b"LN:"):
                            ln = int(fld[3:])
                    if name is not None:
                        self.ref_names.append(name)
                        self.ref_lens.append(ln)
            else:
                self._pending = line
                break
        self.header_text = "".join(header_lines)
        self.name2tid: Dict[str, int] = {n: i for i, n in enumerate(self.ref_names)}

    def close(self):
        self._fp.close()

    def _parse(self, line: bytes) -> Optional[BamRecord]:
        fields = line.rstrip(b"\r\n").split(b"\t")
        if len(fields) < 11:
            return None
        flag = int(fields[1])
        rname = fields[2].decode("latin-1")
        tid = self.name2tid.get(rname, -1)
        pos = int(fields[3]) - 1  # SAM is 1-based
        cigar: List[Tuple[int, int]] = []
        cs = fields[5].decode("latin-1")
        if cs != "*":
            num = ""
            for ch in cs:
                if ch.isdigit():
                    num += ch
                else:
                    cigar.append((_CIGAR_CODE[ch], int(num)))
                    num = ""
        seq = fields[9].decode("latin-1")
        # htslib normalization: '*' means no sequence stored (l_qseq=0);
        # lowercase bases map through seq_nt16_table to uppercase
        seq = "" if seq == "*" else seq.upper()
        return BamRecord(tid=tid, pos=pos, flag=flag, cigar=cigar, seq=seq)

    def records(self) -> Iterator[BamRecord]:
        if self._pending is not None:
            rec = self._parse(self._pending)
            self._pending = None
            if rec is not None:
                yield rec
        for line in self._fp:
            if line.startswith(b"@"):
                continue
            rec = self._parse(line)
            if rec is not None:
                yield rec


def open_alignment(path: str):
    """BamReader for BAM (BGZF magic), CramReader for CRAM, SamTextReader
    for SAM text — the sam_open() format sniff (bam-vaf-counter.c:24 gets
    all three transparently from htslib)."""
    import os

    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"\x1f\x8b":
        try:
            return BamReader(path)
        except ValueError:
            return SamTextReader(path)  # gzipped SAM text
    if magic == b"CRAM":
        from .cram import CramReader

        return CramReader(path,
                          reference=os.environ.get("KMER_TPU_CRAM_REF"))
    return SamTextReader(path)
