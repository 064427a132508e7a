"""Minimal VCF/BCF reader (a copy of kmer_tpu/io/vcf.py) — the htslib
surface used by vcf-vaf-counter
(the reference's vcf-vaf-counter.c:97-204): iterate records; per record
expose chrom, pos, alleles, per-sample GT and FORMAT AD/DP integers.

Handles plain and gzip/BGZF-compressed text VCF, and binary BCF2.2
(uncompressed layout per the BCF spec as implemented in htslib vcf.c).
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator, List, Optional

from .bgzf import BgzfReader

INT32_MISSING = -2147483648


class VcfRecord:
    """One variant record.  chrom/pos/alleles are eager (callers filter
    on them); the per-sample FORMAT fields (GT/AD/DP) parse lazily on
    first access — vcf-vaf-counter touches them only for the ~21k
    records matching a SNP pattern, a tiny fraction of a whole-genome
    VCF (mirrors htslib's bcf_unpack levels)."""

    __slots__ = ("chrom", "pos", "alleles", "_lazy", "_gts", "_ad", "_dp")

    def __init__(self, chrom: str, pos: int, alleles: List[str],
                 lazy=None, gts=None, ad=None, dp=None):
        self.chrom = chrom
        self.pos = pos  # 0-based
        self.alleles = alleles
        self._lazy = lazy  # callable -> (gts, ad, dp), or None
        self._gts = gts if gts is not None else ([] if lazy is None else None)
        self._ad = ad
        self._dp = dp

    def _ensure(self):
        if self._lazy is not None:
            g, a, d = self._lazy()
            self._gts = g if g is not None else []
            self._ad = a
            self._dp = d
            self._lazy = None

    @property
    def gts(self) -> List[List[int]]:  # per sample allele idx, -1 missing
        self._ensure()
        return self._gts

    @property
    def ad(self) -> Optional[List[List[int]]]:  # per sample per allele
        self._ensure()
        return self._ad

    @property
    def dp(self) -> Optional[List[int]]:
        self._ensure()
        return self._dp


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=f)
    return f


def _parse_gt(gt_str: str) -> List[int]:
    out = []
    for tok in gt_str.replace("|", "/").split("/"):
        if tok in (".", ""):
            out.append(-1)
        else:
            try:
                out.append(int(tok))
            except ValueError:
                out.append(-1)
    return out


def read_vcf(path: str) -> Iterator[VcfRecord]:
    with open(path, "rb") as probe:
        head = probe.read(4)
    if head[:2] == b"\x1f\x8b":
        try:  # BGZF-compressed BCF?  (plain gzip VCF raises here)
            br = BgzfReader(path)
            inner = br.read(3)
            br.close()
        except ValueError:
            inner = b""
        if inner == b"BCF":
            yield from _read_bcf(path)
            return
    f = _open_text(path)
    for raw in f:
        line = raw.decode(errors="replace").rstrip("\n")
        if line.startswith("#") or not line:
            continue
        # split only through ALT eagerly; FORMAT+samples stay one string
        t = line.split("\t", 8)
        if len(t) < 8:
            continue
        chrom, pos_s, _id, ref, alt = t[0], t[1], t[2], t[3], t[4]
        alleles = [ref] + (alt.split(",") if alt != "." else [])
        lazy = None
        if len(t) == 9:
            rest = t[8]
            n_all = len(alleles)

            def lazy(rest=rest, n_all=n_all):
                return _parse_text_format(rest, n_all)

        yield VcfRecord(chrom, int(pos_s) - 1, alleles, lazy=lazy)
    f.close()


def _parse_text_format(rest: str, n_alleles: int):
    """Parse 'FORMAT\\tS1\\tS2...' into (gts, ad, dp) lazily."""
    fields = rest.split("\t")
    if len(fields) < 2:
        return None, None, None
    fmt = fields[0].split(":")
    gt_i = fmt.index("GT") if "GT" in fmt else -1
    ad_i = fmt.index("AD") if "AD" in fmt else -1
    dp_i = fmt.index("DP") if "DP" in fmt else -1
    gts, ad_all, dp_all = [], [], []
    for s in fields[1:]:
        sv = s.split(":")
        gts.append(_parse_gt(sv[gt_i]) if 0 <= gt_i < len(sv) else [-1])
        if ad_i >= 0 and ad_i < len(sv) and sv[ad_i] not in (".", ""):
            ad_all.append(
                [
                    int(x) if x not in (".", "") else INT32_MISSING
                    for x in sv[ad_i].split(",")
                ]
            )
        else:
            ad_all.append([INT32_MISSING] * n_alleles)
        if dp_i >= 0 and dp_i < len(sv) and sv[dp_i] not in (".", ""):
            dp_all.append(int(sv[dp_i]))
        else:
            dp_all.append(INT32_MISSING)
    return gts, (ad_all if ad_i >= 0 else None), (dp_all if dp_i >= 0 else None)


# ---------------- BCF2 ----------------

def _read_typed_int(buf, off):
    t = buf[off]
    off += 1
    ty = t & 0xF
    if ty == 1:
        return struct.unpack_from("<b", buf, off)[0], off + 1
    if ty == 2:
        return struct.unpack_from("<h", buf, off)[0], off + 2
    if ty == 3:
        return struct.unpack_from("<i", buf, off)[0], off + 4
    raise ValueError(f"unexpected typed int type {ty}")


def _read_typed(buf, off):
    """Read a typed value block: returns (type, values_list, new_off)."""
    t = buf[off]
    off += 1
    ty = t & 0xF
    n = t >> 4
    if n == 15:
        n, off = _read_typed_int(buf, off)
    if ty == 0:
        return ty, [], off
    if ty == 1:
        vals = list(struct.unpack_from(f"<{n}b", buf, off))
        return ty, vals, off + n
    if ty == 2:
        vals = list(struct.unpack_from(f"<{n}h", buf, off))
        return ty, vals, off + 2 * n
    if ty == 3:
        vals = list(struct.unpack_from(f"<{n}i", buf, off))
        return ty, vals, off + 4 * n
    if ty == 5:
        vals = list(struct.unpack_from(f"<{n}f", buf, off))
        return ty, vals, off + 4 * n
    if ty == 7:
        return ty, buf[off : off + n].decode(errors="replace"), off + n
    raise ValueError(f"unsupported BCF type {ty}")


_BCF_MISSING = {1: -128, 2: -32768, 3: -2147483648}
_BCF_EOV = {1: -127, 2: -32767, 3: -2147483647}


def _read_bcf(path: str) -> Iterator[VcfRecord]:
    br = BgzfReader(path)
    magic = br.read(5)
    if magic[:3] != b"BCF":
        raise ValueError("not a BCF file")
    (l_text,) = struct.unpack("<I", br.read(4))
    header_text = br.read(l_text).split(b"\x00")[0].decode(errors="replace")
    contigs: List[str] = []
    fmt_ids = {}
    idx_counter = 0
    explicit_idx = False
    for line in header_text.split("\n"):
        if line.startswith("##contig=<"):
            body = line[len("##contig=<") : line.rfind(">")]
            name = None
            for kv in body.split(","):
                if kv.startswith("ID="):
                    name = kv[3:]
            contigs.append(name or f"contig{len(contigs)}")
        elif (
            line.startswith("##INFO=<")
            or line.startswith("##FORMAT=<")
            or line.startswith("##FILTER=<")
        ):
            body = line[line.index("<") + 1 : line.rfind(">")]
            name = None
            idx = None
            for kv in body.split(","):
                if kv.startswith("ID="):
                    name = kv[3:]
                elif kv.startswith("IDX="):
                    idx = int(kv[4:])
                    explicit_idx = True
            if name is not None and name not in fmt_ids:
                if idx is None:
                    idx = idx_counter
                fmt_ids[name] = idx
            idx_counter += 1
    # implicit dictionary: PASS is always index 0
    if not explicit_idx:
        ids = ["PASS"]
        for line in header_text.split("\n"):
            if line.startswith(("##INFO=<", "##FORMAT=<", "##FILTER=<")):
                body = line[line.index("<") + 1 : line.rfind(">")]
                name = None
                for kv in body.split(","):
                    if kv.startswith("ID="):
                        name = kv[3:]
                if name and name not in ids:
                    ids.append(name)
        fmt_ids = {n: i for i, n in enumerate(ids)}
    id_gt = fmt_ids.get("GT", -1)
    id_ad = fmt_ids.get("AD", -1)
    id_dp = fmt_ids.get("DP", -1)

    while True:
        head = br.read(8)
        if len(head) < 8:
            break
        l_shared, l_indiv = struct.unpack("<II", head)
        shared = br.read(l_shared)
        indiv = br.read(l_indiv)
        rid, pos, _rlen, _qual, n_info_allele, n_fmt_sample = struct.unpack_from(
            "<iiifII", shared, 0
        )
        n_allele = n_info_allele >> 16
        n_info = n_info_allele & 0xFFFF
        n_fmt = n_fmt_sample >> 24
        ns = n_fmt_sample & 0xFFFFFF
        off = 24
        _, _id_str, off = _read_typed(shared, off)
        alleles = []
        for _ in range(n_allele):
            _, a, off = _read_typed(shared, off)
            alleles.append(a)
        def lazy(indiv=indiv, n_fmt=n_fmt, ns=ns):
            return _parse_bcf_format(indiv, n_fmt, ns, id_gt, id_ad, id_dp)

        yield VcfRecord(
            contigs[rid] if rid < len(contigs) else str(rid), pos, alleles,
            lazy=lazy,
        )
    br.close()


def _parse_bcf_format(indiv, n_fmt, ns, id_gt, id_ad, id_dp):
    """Walk the per-sample FORMAT blocks lazily (bcf_unpack FMT level)."""
    off = 0
    gts = None
    ad = None
    dp = None
    for _ in range(n_fmt):
        key, off = _read_typed_int(indiv, off)
        t = indiv[off]
        off += 1
        ty = t & 0xF
        per = t >> 4
        if per == 15:
            per, off = _read_typed_int(indiv, off)
        width = {0: 0, 1: 1, 2: 2, 3: 4, 5: 4, 7: 1}[ty]
        total = per * ns * width
        blob = indiv[off : off + total]
        off += total
        if key not in (id_gt, id_ad, id_dp) or ty not in (1, 2, 3):
            continue
        fmtc = {1: "b", 2: "h", 3: "i"}[ty]
        vals = struct.unpack(f"<{per * ns}{fmtc}", blob)
        missing = _BCF_MISSING[ty]
        eov = _BCF_EOV[ty]
        rows = [list(vals[i * per : (i + 1) * per]) for i in range(ns)]
        if key == id_gt:
            gts = [
                [
                    -1 if v in (missing, eov) or v == 0 else ((v >> 1) - 1)
                    for v in row
                ]
                for row in rows
            ]
        elif key == id_ad:
            ad = [
                [INT32_MISSING if v in (missing, eov) else v for v in row]
                for row in rows
            ]
        elif key == id_dp:
            dp = [
                INT32_MISSING if row[0] in (missing, eov) else row[0]
                for row in rows
            ]
    return gts, ad, dp
