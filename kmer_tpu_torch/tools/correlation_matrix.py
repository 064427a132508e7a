"""correlation-matrix — depth-aware Pearson correlation across VAF files
(a copy of kmer_tpu/tools/correlation_matrix.py: host code only).

Reference parity with the reference tool correlation-matrix.c:254-410,
including the preset modes (matched/unmatched/strict), the NGSCheckMate
epsilon guard, and the UPGMA-like dendrogram (-t).

The Pearson accumulations run as sequential Python-float (C double)
folds in the reference's exact 3-pass order
(correlation-matrix.c:94-142), so the %.6f output is bit-identical.
Sample counts here are small (<=1000); the heavy lifting of the
pipeline lives upstream on the device.
"""

from __future__ import annotations

import math

import numpy as np
import sys

from ..io.formats import read_vaf_file, write_corr_matrix
from ..utils.cli import c_atoi, ketopt
from ..utils.log import minfo

MAX_SNPS = 100000


def pearson_depth_aware_np(x, dx, y, dy, min_snps, min_depth):
    """Vectorized pearson_depth_aware over numpy f64 arrays.

    Bit-identical to the scalar C loop (correlation-matrix.c:94-142):
    every reduction is a masked np.cumsum final element, which
    accumulates left to right into a running f64 exactly like the C
    loop (adding 0.0 for masked-out lanes leaves the running sum's bits
    unchanged), NOT np.sum (pairwise reduction, different rounding).
    ~100x the pure-Python loops for large cohorts (the reference caps
    at 1000 samples x 100K SNPs).

    Samples with DIFFERENT row counts: the reference loops to sample
    i's n_snps (correlation-matrix.c:155) over malloc'd MAX_SNPS
    arrays, so rows past sample j's count read fresh-mmap zero pages
    (vaf 0.0, depth 0).  Reproduce exactly: truncate/zero-pad the
    SECOND sample to the first's length — with min_depth >= 1 the
    zero-depth tail is excluded, and with -d 0 it participates with
    vaf 0.0 just as the zero pages do in the C."""
    n = x.shape[0]
    if y.shape[0] < n:
        y = np.concatenate([y, np.zeros(n - y.shape[0], y.dtype)])
        dy = np.concatenate([dy, np.zeros(n - dy.shape[0], dy.dtype)])
    else:
        y, dy = y[:n], dy[:n]
    m = (dx >= min_depth) & (dy >= min_depth)
    valid_count = int(np.count_nonzero(m))
    if valid_count < min_snps:
        return 0.0
    xm = np.where(m, x, 0.0)
    ym = np.where(m, y, 0.0)
    sum_x = float(np.cumsum(xm)[-1])
    sum_y = float(np.cumsum(ym)[-1])
    mean_x = sum_x / valid_count
    mean_y = sum_y / valid_count
    dxi = np.where(m, x - mean_x, 0.0)
    dyi = np.where(m, y - mean_y, 0.0)
    sum_xy = float(np.cumsum(dxi * dyi)[-1])
    sum_x2 = float(np.cumsum(dxi * dxi)[-1])
    sum_y2 = float(np.cumsum(dyi * dyi)[-1])
    denom_x = math.sqrt(sum_x2)
    denom_y = math.sqrt(sum_y2)
    if denom_x < 1e-10 or denom_y < 1e-10:
        return sum_xy / (math.sqrt(sum_x2 * sum_y2) + 0.00001)
    return sum_xy / (denom_x * denom_y)


def pearson_depth_aware(x, dx, y, dy, n, min_snps, min_depth):
    """correlation-matrix.c:94-142, same pass structure and fp order."""
    valid_count = 0
    for i in range(n):
        if dx[i] >= min_depth and dy[i] >= min_depth:
            valid_count += 1
    if valid_count < min_snps:
        return 0.0
    sum_x = 0.0
    sum_y = 0.0
    for i in range(n):
        if dx[i] >= min_depth and dy[i] >= min_depth:
            sum_x += x[i]
            sum_y += y[i]
    mean_x = sum_x / valid_count
    mean_y = sum_y / valid_count
    sum_xy = sum_x2 = sum_y2 = 0.0
    for i in range(n):
        if dx[i] >= min_depth and dy[i] >= min_depth:
            dxi = x[i] - mean_x
            dyi = y[i] - mean_y
            sum_xy += dxi * dyi
            sum_x2 += dxi * dxi
            sum_y2 += dyi * dyi
    denom_x = math.sqrt(sum_x2)
    denom_y = math.sqrt(sum_y2)
    if denom_x < 1e-10 or denom_y < 1e-10:
        return sum_xy / (math.sqrt(sum_x2 * sum_y2) + 0.00001)
    return sum_xy / (denom_x * denom_y)


def build_tree(samples, corr_matrix, tree_fp):
    """UPGMA-like clustering on distance 1-r, average linkage
    (correlation-matrix.c:191-252)."""
    n = len(samples)
    dist = [[1.0 - corr_matrix[i][j] for j in range(n)] for i in range(n)]
    active = [True] * n
    tree_fp.write("# Simple dendrogram (UPGMA-like clustering)\n")
    tree_fp.write("# Format: (Sample1:distance, Sample2:distance)\n")
    n_active = n
    while n_active > 1:
        min_dist, min_i, min_j = 1e10, -1, -1
        for i in range(n):
            if not active[i]:
                continue
            for j in range(i + 1, n):
                if not active[j]:
                    continue
                if dist[i][j] < min_dist:
                    min_dist, min_i, min_j = dist[i][j], i, j
        if min_i == -1 or min_j == -1:
            break
        tree_fp.write(
            f"Cluster: {samples[min_i].name} ({min_dist / 2:.4f}) <-> "
            f"{samples[min_j].name} ({min_dist / 2:.4f})\n"
        )
        for kk in range(n):
            if kk == min_i or kk == min_j or not active[kk]:
                continue
            dist[min_i][kk] = (dist[min_i][kk] + dist[min_j][kk]) / 2.0
            dist[kk][min_i] = dist[min_i][kk]
        active[min_j] = False
        n_active -= 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_fn = None
    build_tree_flag = False
    mode = None
    min_snps, min_depth = 20, 1
    custom_min_snps = custom_min_depth = False
    opts, pos = ketopt(argv, "o:tm:d:M:")
    for c, a in opts:
        if c == "o":
            out_fn = a
        elif c == "t":
            build_tree_flag = True
        elif c == "m":
            min_snps = c_atoi(a)
            custom_min_snps = True
        elif c == "d":
            min_depth = c_atoi(a)
            custom_min_depth = True
        elif c == "M":
            mode = a

    if mode:
        if mode == "matched":
            if not custom_min_depth:
                min_depth = 5
            if not custom_min_snps:
                min_snps = 10
            minfo("main", f"Using 'matched' mode: min_depth={min_depth}, min_snps={min_snps}")
        elif mode in ("unmatched", "default"):
            if not custom_min_depth:
                min_depth = 1
            if not custom_min_snps:
                min_snps = 20
            minfo("main", f"Using 'unmatched' mode: min_depth={min_depth}, min_snps={min_snps}")
        elif mode == "strict":
            if not custom_min_depth:
                min_depth = 10
            if not custom_min_snps:
                min_snps = 30
            minfo("main", f"Using 'strict' mode: min_depth={min_depth}, min_snps={min_snps}")
        else:
            sys.stderr.write(
                f"Error: unknown mode '{mode}'. Valid modes: matched, unmatched, strict\n"
            )
            return 1

    n_samples = len(pos)
    if not out_fn or n_samples < 2:
        e = sys.stderr
        e.write(
            "Usage: correlation-matrix -o <output.corr> [-t] [-M MODE] [-m INT] [-d INT] "
            "<sample1.vaf> <sample2.vaf> [sample3.vaf ...]\n"
        )
        e.write("Options:\n")
        e.write("  -o FILE    output correlation matrix file\n")
        e.write("  -t         build tree/dendrogram (outputs to <output.tree>)\n")
        e.write("  -M MODE    preset mode: 'matched' (same individual, depth≥5, SNPs≥10),\n")
        e.write("                          'unmatched' (related/unrelated, depth≥1, SNPs≥20),\n")
        e.write("                          'strict' (high confidence, depth≥10, SNPs≥30)\n")
        e.write(f"  -m INT     minimum SNPs with sufficient depth required [{min_snps}]\n")
        e.write(f"  -d INT     minimum depth per SNP [{min_depth}]\n")
        e.write("\nNote: -m and -d override preset mode values\n")
        return 1

    minfo("main", f"Loading {n_samples} VAF files...")
    samples = []
    for p in pos:
        try:
            s = read_vaf_file(p, MAX_SNPS)
        except OSError:
            sys.stderr.write(f"Error: failed to load {p}\n")
            return 1
        samples.append(s)
        minfo("main", f"Loaded {s.name}: {len(s.vaf)} SNPs")

    minfo("main", "Computing correlation matrix...")
    vafs = [np.asarray(s.vaf, np.float64) for s in samples]
    depths = [np.asarray(s.depth, np.float64) for s in samples]
    corr = [[0.0] * n_samples for _ in range(n_samples)]
    for i in range(n_samples):
        corr[i][i] = 1.0
        for j in range(i + 1, n_samples):
            r = pearson_depth_aware_np(
                vafs[i], depths[i], vafs[j], depths[j], min_snps, min_depth
            )
            corr[i][j] = r
            corr[j][i] = r

    minfo("main", "Writing correlation matrix...")
    write_corr_matrix(out_fn, [s.name for s in samples], corr)
    minfo("main", f"Correlation matrix written to {out_fn}")

    if build_tree_flag:
        tree_fn = out_fn
        if ".corr" in tree_fn:
            tree_fn = tree_fn[: tree_fn.index(".corr")] + ".tree"
        else:
            tree_fn = tree_fn + ".tree"
        minfo("main", "Building dendrogram...")
        with open(tree_fn, "w") as tree_fp:
            build_tree(samples, corr, tree_fp)
        minfo("main", f"Dendrogram written to {tree_fn}")
    return 0
