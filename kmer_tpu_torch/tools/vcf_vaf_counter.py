"""vcf-vaf-counter — VAF files from VCF/BCF genotypes (a copy of
kmer_tpu/tools/vcf_vaf_counter.py: host code only).

Reference parity with the reference's vcf-vaf-counter.c:206-278:
biallelic-SNP + allele-match filters, genotype from GT, depth from
FORMAT/AD else estimated from DP+GT (hom -> all one allele, het ->
50/50 with ref getting floor), min-depth filter, counts *assigned* (not
accumulated) so the last matching record wins.
"""

from __future__ import annotations

import sys

from ..io.formats import read_patterns, write_vaf_file
from ..io.vcf import INT32_MISSING, read_vcf
from ..utils.cli import c_atoi, ketopt
from ..utils.log import minfo


def process_vcf(fn, patterns, sample_idx, min_depth):
    by_pos = {}
    for i, p in enumerate(patterns):
        by_pos.setdefault((p.chr, p.start), i)

    try:
        open(fn, "rb").close()
    except OSError:
        # the reference warns and still writes the (all-zero) VAF file
        # (vcf-vaf-counter.c:105, main continues after the message)
        sys.stderr.write(f"Error: failed to open VCF file: {fn}\n")
        return

    for rec in read_vcf(fn):
        pat_idx = by_pos.get((rec.chrom, rec.pos))
        if pat_idx is None:
            continue
        p = patterns[pat_idx]
        if len(rec.alleles) != 2:
            continue
        if len(rec.alleles[0]) != 1 or len(rec.alleles[1]) != 1:
            continue
        if rec.alleles[0] != p.ref or rec.alleles[1] != p.alt:
            continue
        if sample_idx >= len(rec.gts):
            continue
        gt = rec.gts[sample_idx]
        if len(gt) < 2:
            continue
        a1, a2 = gt[0], gt[1]
        if a1 < 0 or a2 < 0:
            continue
        depth = 0
        ref_depth = alt_depth = 0
        if rec.ad is not None and sample_idx < len(rec.ad):
            row = rec.ad[sample_idx]
            if (
                len(row) >= 2
                and row[0] != INT32_MISSING
                and row[1] != INT32_MISSING
            ):
                ref_depth, alt_depth = row[0], row[1]
                depth = ref_depth + alt_depth
        if depth == 0 and rec.dp is not None and sample_idx < len(rec.dp):
            d = rec.dp[sample_idx]
            if d != INT32_MISSING:
                depth = d
                if a1 == 0 and a2 == 0:
                    ref_depth, alt_depth = depth, 0
                elif a1 == 1 and a2 == 1:
                    ref_depth, alt_depth = 0, depth
                else:
                    ref_depth = depth // 2
                    alt_depth = depth - ref_depth
        if depth < min_depth:
            continue
        p.ref_count = ref_depth
        p.alt_count = alt_depth


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sample_idx, min_depth = 0, 1
    pattern_fn = out_fn = vcf_fn = None
    opts, _pos = ketopt(argv, "p:o:v:s:d:")
    for c, a in opts:
        if c == "p":
            pattern_fn = a
        elif c == "o":
            out_fn = a
        elif c == "v":
            vcf_fn = a
        elif c == "s":
            sample_idx = c_atoi(a)
        elif c == "d":
            min_depth = c_atoi(a)
    if not pattern_fn or not out_fn or not vcf_fn:
        e = sys.stderr
        e.write(
            "Usage: vcf-vaf-counter [options] -p <patterns.txt> -v <input.vcf> -o <output.vaf>\n"
        )
        e.write("Options:\n")
        e.write("  -p FILE   input pattern file\n")
        e.write("  -v FILE   input VCF/BCF file\n")
        e.write("  -o FILE   output VAF file\n")
        e.write(f"  -s INT    sample index (0-based) [{sample_idx}]\n")
        e.write(f"  -d INT    minimum depth [{min_depth}]\n")
        return 1

    minfo("main", "Loading patterns...")
    try:
        patterns = read_patterns(pattern_fn)
    except OSError:
        sys.stderr.write("Error: failed to load pattern file\n")
        return 1
    minfo("main", f"Loaded {len(patterns)} patterns")

    minfo("main", "Processing VCF file...")
    process_vcf(vcf_fn, patterns, sample_idx, min_depth)

    minfo("main", "Writing VAF file...")
    avg_depth = write_vaf_file(out_fn, patterns)
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")
    return 0
