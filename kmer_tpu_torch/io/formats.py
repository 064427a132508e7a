"""Text file formats of the SNP pipeline: BED, pattern, VAF, correlation
(a copy of kmer_tpu/io/formats.py).

Byte-stable with the reference writers:
  pattern row  — snp-pattern-gen.c:351-353
  VAF file     — vaf-counter.c:668-677 (`# Average depth: %.2f` header,
                 9-column rows with %.4f VAF)
  correlation  — correlation-matrix.c:364-377 (header + %.6f matrix)
"""

from __future__ import annotations

import os
import sys

import numpy as np

from dataclasses import dataclass, field
from typing import List, Optional, TextIO, Tuple


@dataclass
class Snp:
    chr: str
    start: int
    end: int
    rsid: str
    ref: str
    alt: str


@dataclass
class Pattern(Snp):
    ref_kmer: str = ""
    alt_kmer: str = ""
    ref_count: int = 0
    alt_count: int = 0


class _ScanFail(Exception):
    pass


_WS = frozenset(b" \t\n\r\x0b\x0c")


class _Scanner:
    """Byte-exact fscanf emulator for the fixed formats the reference
    readers use.  Tokens are whitespace-delimited ACROSS newlines,
    %Ns width caps split long tokens mid-token (the tail feeds the
    next directive), " %c" takes one char (possibly the second char of
    a multi-char token), and the first failed directive ends the whole
    load — later records are dropped, exactly like the C loops."""

    def __init__(self, data: bytes):
        self.d = data
        self.n = len(data)
        self.p = 0

    def _skip_ws(self):
        d, n = self.d, self.n
        p = self.p
        while p < n and d[p] in _WS:
            p += 1
        self.p = p

    def s(self, width: int) -> str:
        """%<width>s: >=1 non-whitespace chars, at most width."""
        self._skip_ws()
        d, n = self.d, self.n
        st = p = self.p
        while p < n and d[p] not in _WS and p - st < width:
            p += 1
        if p == st:
            raise _ScanFail
        self.p = p
        return d[st:p].decode("latin-1")

    def i(self) -> int:
        """%d: optional sign + >=1 digits."""
        self._skip_ws()
        d, n = self.d, self.n
        st = p = self.p
        if p < n and d[p] in b"+-":
            p += 1
        dst = p
        while p < n and 0x30 <= d[p] <= 0x39:
            p += 1
        if p == dst:
            raise _ScanFail
        self.p = p
        # glibc %d: strtol saturates to LONG_MAX/LONG_MIN, then the
        # value is cast to int (verified against the compiled oracles:
        # +overflow -> -1, -overflow -> 0)
        v = int(d[st:p])
        v = max(min(v, 2**63 - 1), -(2**63))
        v &= 0xFFFFFFFF
        return v - 2**32 if v >= 2**31 else v

    def c(self) -> str:
        """' %c': skip whitespace, then exactly one char."""
        self._skip_ws()
        if self.p >= self.n:
            raise _ScanFail
        ch = self.d[self.p]
        self.p += 1
        return chr(ch)


def read_bed_snps(path: str) -> List[Snp]:
    """6-column SNP BED, via the reference's exact
    `fscanf("%254s%d%d%254s %c %c")` token semantics
    (snp-pattern-gen.c:271)."""
    with open(path, "rb") as f:
        sc = _Scanner(f.read())
    out = []
    while True:
        try:
            out.append(Snp(sc.s(254), sc.i(), sc.i(), sc.s(254),
                           sc.c(), sc.c()))
        except _ScanFail:
            return out


def read_patterns(path: str) -> List[Pattern]:
    """8-column pattern file, via the reference's exact
    `fscanf("%255s%d%d%255s %c %c%127s%127s")` token semantics
    (load_patterns — vaf-counter.c:164, ed-vaf-counter.c:62,
    bam-vaf-counter.c:80, vcf-vaf-counter.c:52): k-mers longer than
    127 bases split mid-token and derail the remaining records, just
    like the C tools."""
    with open(path, "rb") as f:
        sc = _Scanner(f.read())
    out = []
    while True:
        try:
            out.append(Pattern(sc.s(255), sc.i(), sc.i(), sc.s(255),
                               sc.c(), sc.c(), sc.s(127), sc.s(127)))
        except _ScanFail:
            return out


def write_pattern_row(fp: TextIO, s: Snp, ref_kmer: str, alt_kmer: str) -> None:
    fp.write(
        f"{s.chr}\t{s.start}\t{s.end}\t{s.rsid}\t{s.ref}\t{s.alt}\t{ref_kmer}\t{alt_kmer}\n"
    )


def write_vaf_file(path: str, patterns: List[Pattern]) -> float:
    """Returns the average depth written in the header."""
    total = sum(p.ref_count + p.alt_count for p in patterns)
    avg_depth = total / (len(patterns) if patterns else 1)
    # latin-1 keeps non-ASCII input bytes byte-transparent, like the C
    # tools' opaque char copies (fields come from the latin-1 scanner)
    with open(path, "w", encoding="latin-1") as fp:
        fp.write(f"# Average depth: {avg_depth:.2f}\n")
        fp.write("CHR\tPOS\tRSID\tREF\tALT\tREF_COUNT\tALT_COUNT\tTOTAL_COUNT\tVAF\n")
        for p in patterns:
            tot = p.ref_count + p.alt_count
            vaf = p.alt_count / tot if tot > 0 else 0.0
            fp.write(
                f"{p.chr}\t{p.start}\t{p.rsid}\t{p.ref}\t{p.alt}\t"
                f"{p.ref_count}\t{p.alt_count}\t{tot}\t{vaf:.4f}\n"
            )
    return avg_depth


@dataclass
class VafSample:
    name: str
    vaf: List[float] = field(default_factory=list)
    depth: List[int] = field(default_factory=list)
    snps: List[Tuple[str, int, str]] = field(default_factory=list)


def read_vaf_file(path: str, max_snps: int = 100000) -> VafSample:
    """Parse a VAF file (load_vaf_file, correlation-matrix.c:25-90):
    sample name = basename minus .vaf; rows capped at max_snps.

    Loading dominated correlation-matrix runtime at its documented
    limits (1000 samples x 100k SNPs), so the well-formed fast path goes
    through pandas' C csv engine; any deviation falls back to the
    row-by-row loop with identical semantics."""
    base = os.path.basename(path)
    if ".vaf" in base:
        base = base[: base.index(".vaf")]
    s = VafSample(base)
    try:
        import io as _io

        import pandas as pd

        with open(path, "rb") as f:
            raw = f.read()
        # strip leading comment/header lines; per-line filtering only
        # when comments appear mid-body (never in machine-written VAFs)
        start = 0
        while start < len(raw):
            nl = raw.find(b"\n", start)
            end = nl if nl >= 0 else len(raw)
            ln = raw[start:end]
            if ln and not ln.startswith(b"#") and not ln.startswith(b"CHR"):
                break
            start = end + 1 if nl >= 0 else len(raw)
        body = raw[start:]
        if b"\n#" in body or b"\nCHR" in body:
            body = b"\n".join(
                ln
                for ln in body.split(b"\n")
                if ln
                and not ln.startswith(b"#")
                and not ln.startswith(b"CHR")
            )
        if not body.strip():
            return s
        df = pd.read_csv(
            _io.BytesIO(body), sep="\t", header=None,
            dtype={0: str, 1: np.int64, 2: str, 7: np.int64, 8: np.float64},
            usecols=[0, 1, 2, 7, 8],
            engine="c", on_bad_lines="skip", quoting=3, na_filter=False,
        )
        if df.shape[1] != 5:
            raise ValueError("ragged VAF rows")
        n_body_lines = sum(1 for ln in body.split(b"\n") if ln.strip())
        if len(df) != n_body_lines:
            # on_bad_lines="skip" silently drops rows whose field count
            # differs from the first row's (e.g. an extra annotation
            # column appended by another tool) — the reference's sscanf
            # keeps such rows (first 9 fields, correlation-matrix.c:63),
            # so any skip must divert to the exact fallback loop below
            raise ValueError("VAF rows with mismatched field counts")
        if len(df) > max_snps:
            sys.stderr.write(
                f"Warning: too many SNPs (max {max_snps}), truncating\n"
            )
        df = df.iloc[:max_snps]
        pos = df[1].astype(np.int64)
        depth = df[7].astype(np.int64)
        vaf = df[8].astype(np.float64)
        s.snps = list(zip(df[0].tolist(), pos.tolist(), df[2].tolist()))
        s.vaf = vaf.tolist()
        s.depth = depth.tolist()
        return s
    except Exception:
        s = VafSample(base)
    with open(path) as f:
        for line in f:
            if line.startswith("#") or line.startswith("CHR"):
                continue
            t = line.split("\t")
            if len(t) < 9:  # sscanf parses the first 9 fields and
                continue    # ignores trailing ones (correlation-matrix.c:63)
            if len(s.vaf) >= max_snps:
                sys.stderr.write(
                    f"Warning: too many SNPs (max {max_snps}), truncating\n"
                )
                break
            try:
                row = (t[0], int(t[1]), t[2]), float(t[8]), int(t[7])
            except ValueError:
                continue  # non-numeric field: sscanf returns != 9, row skipped
            s.snps.append(row[0])
            s.vaf.append(row[1])
            s.depth.append(row[2])
    return s


def read_vaf_avg_depth(path: str) -> Optional[float]:
    """First-line `# Average depth:` header (match-classifier.c:142-149)."""
    with open(path) as f:
        line = f.readline()
        if line.startswith("#"):
            try:
                return float(line.split("Average depth:")[1])
            except (IndexError, ValueError):
                return None
    return None


def write_corr_matrix(path: str, names: List[str], matrix) -> None:
    with open(path, "w") as fp:
        fp.write("Sample")
        for n in names:
            fp.write(f"\t{n}")
        fp.write("\n")
        for i, n in enumerate(names):
            fp.write(n)
            for j in range(len(names)):
                fp.write(f"\t{matrix[i][j]:.6f}")
            fp.write("\n")


def read_corr_matrix(path: str):
    """Returns (names, matrix) — load_correlation_matrix
    (match-classifier.c:26-108)."""
    with open(path) as f:
        header = f.readline().split("\t")
        if not header or header[0].strip() != "Sample":
            raise ValueError("not a correlation matrix file")
        names = [h.strip() for h in header[1:] if h.strip()]
        n = len(names)
        matrix = [[0.0] * n for _ in range(n)]
        for i in range(n):
            line = f.readline()
            if not line:
                break
            t = line.rstrip("\n").split("\t")
            for j in range(n):
                if j + 1 < len(t):
                    matrix[i][j] = float(t[j + 1])
    return names, matrix
