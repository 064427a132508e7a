"""match-classifier — classify sample pairs as MATCHED/UNMATCHED (a copy
of kmer_tpu/tools/match_classifier.py: host code only).

Reference parity with the reference tool match-classifier.c:426-516: fixed
threshold (-t), trained threshold from known pairs (-T), or the
NGSCheckMate predefined depth-stratified model (-P, -F family mode)
with the exact Gaussian-parameter table
(match-classifier.c:172-247)."""

from __future__ import annotations

import sys

from ..io.formats import read_corr_matrix, read_vaf_avg_depth
from ..utils.cli import c_atof, ketopt
from ..utils.log import minfo

# (depth_gt, mean_matched, std_matched, mean_unmatched, std_unmatched)
_MODEL_FAMILY = [
    (10, 0.874611, 0.022596, 0.644481, 0.020908),
    (5, 0.785312, 0.021318, 0.596133, 0.022502),
    (2, 0.650299, 0.019252, 0.5346, 0.020694),
    (1, 0.578582, 0.018379, 0.495017, 0.021652),
    (0.5, 0.524757, 0.023218, 0.465653, 0.027378),
    (None, 0.524757, 0.023218, 0.465653, 0.027378),
]
_MODEL_NONFAMILY = [
    (10, 0.874546, 0.022211, 0.310549, 0.060058),
    (5, 0.785249, 0.021017, 0.279778, 0.054104),
    (2, 0.650573, 0.018699, 0.238972, 0.047196),
    (1, 0.578386, 0.018526, 0.222322, 0.041186),
    (0.5, 0.529327, 0.025785, 0.217839, 0.040334),
    (None, 0.529327, 0.025785, 0.217839, 0.040334),
]


def get_predefined_model(depth: float, family_mode: bool):
    table = _MODEL_FAMILY if family_mode else _MODEL_NONFAMILY
    for gt, mm, sm, mu, su in table:
        if gt is None or depth > gt:
            return mm, sm, mu, su
    return table[-1][1:]


def get_depth_dependent_threshold(d1: float, d2: float, family_mode: bool) -> float:
    mm, _sm, mu, _su = get_predefined_model(min(d1, d2), family_mode)
    return (mm + mu) / 2.0


def calculate_optimal_threshold(names, corr, train_fn: str) -> float:
    """match-classifier.c:340-424 — midpoint of matched/unmatched means."""
    try:
        fp = open(train_fn)
    except OSError:
        sys.stderr.write(
            "Warning: could not open matched pairs file, using default threshold\n"
        )
        return 0.95
    pairs = []
    with fp:
        for line in fp:
            if line.startswith("#"):
                continue
            line = line.rstrip("\n")
            if line:
                pairs.append(line)
            if len(pairs) >= 100:
                break
    n = len(names)
    sum_m = sum_u = 0.0
    n_m = n_u = 0
    for i in range(n):
        for j in range(i + 1, n):
            is_matched = any(
                names[i] in p and names[j] in p for p in pairs
            )
            if is_matched:
                sum_m += corr[i][j]
                n_m += 1
            else:
                sum_u += corr[i][j]
                n_u += 1
    if n_m == 0:
        sys.stderr.write("Warning: no matched pairs found in training data\n")
        return 0.95
    avg_m = sum_m / n_m
    avg_u = sum_u / n_u if n_u > 0 else 0.0
    threshold = (avg_m + avg_u) / 2.0
    minfo("calculate_optimal_threshold", "Training statistics:")
    minfo(
        "calculate_optimal_threshold",
        f"  Matched pairs: {n_m}, avg correlation: {avg_m:.4f}",
    )
    minfo(
        "calculate_optimal_threshold",
        f"  Unmatched pairs: {n_u}, avg correlation: {avg_u:.4f}",
    )
    minfo("calculate_optimal_threshold", f"  Calculated threshold: {threshold:.4f}")
    return threshold


def classify_matches(names, corr, depths, has_depth, base_threshold, out_fp,
                     verbose_mode, family_mode, use_predefined_model):
    """match-classifier.c:264-337."""
    n_matches = 0
    if use_predefined_model and has_depth:
        out_fp.write(
            "# Match classification using NGSCheckMate predefined model "
            f"({'family' if family_mode else 'non-family'} mode)\n"
        )
        out_fp.write("Sample1\tSample2\tDepth1\tDepth2\tCorrelation\tThreshold\tStatus\n")
    elif has_depth:
        out_fp.write(
            f"# Match classification with base threshold {base_threshold:.4f} (depth-adjusted)\n"
        )
        out_fp.write("Sample1\tSample2\tDepth1\tDepth2\tCorrelation\tThreshold\tStatus\n")
    else:
        out_fp.write(
            f"# Match classification with correlation threshold >= {base_threshold:.4f}\n"
        )
        out_fp.write("Sample1\tSample2\tCorrelation\tStatus\n")
    n = len(names)
    for i in range(n):
        for j in range(i + 1, n):
            r = corr[i][j]
            threshold = base_threshold
            if has_depth and use_predefined_model:
                threshold = get_depth_dependent_threshold(
                    depths[i], depths[j], family_mode
                )
            elif has_depth:
                min_depth = min(depths[i], depths[j])
                if min_depth < 5:
                    threshold = base_threshold - 0.05
                elif min_depth > 15:
                    threshold = base_threshold + 0.02
            if r >= threshold:
                status = "MATCHED"
                n_matches += 1
            else:
                status = "UNMATCHED"
            if r >= threshold or verbose_mode:
                if has_depth:
                    out_fp.write(
                        f"{names[i]}\t{names[j]}\t{depths[i]:.2f}\t{depths[j]:.2f}\t"
                        f"{r:.6f}\t{threshold:.4f}\t{status}\n"
                    )
                else:
                    out_fp.write(f"{names[i]}\t{names[j]}\t{r:.6f}\t{status}\n")
    if use_predefined_model:
        minfo("classify_matches", f"Found {n_matches} matched pairs using predefined model")
    else:
        minfo(
            "classify_matches",
            f"Found {n_matches} matched pairs (threshold >= {base_threshold:.4f})",
        )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    verbose_mode = family_mode = use_predefined_model = False
    corr_fn = out_fn = train_fn = None
    threshold = 0.95
    opts, pos = ketopt(argv, "c:o:t:T:vFP")
    for c, a in opts:
        if c == "c":
            corr_fn = a
        elif c == "o":
            out_fn = a
        elif c == "t":
            threshold = c_atof(a)
        elif c == "T":
            train_fn = a
        elif c == "v":
            verbose_mode = True
        elif c == "F":
            family_mode = True
        elif c == "P":
            use_predefined_model = True

    if not corr_fn or not out_fn:
        e = sys.stderr
        e.write(
            "Usage: match-classifier -c <correlation.corr> -o <matches.txt> [options] [VAF files...]\n"
        )
        e.write("Options:\n")
        e.write("  -c FILE    input correlation matrix file\n")
        e.write("  -o FILE    output matches file\n")
        e.write(f"  -t FLOAT   correlation threshold for matching [{threshold:.2f}]\n")
        e.write("  -T FILE    training file with known matched pairs (auto-calculate threshold)\n")
        e.write("  -P         use NGSCheckMate predefined model (requires VAF files for depth)\n")
        e.write("  -F         family mode (for related samples, used with -P)\n")
        e.write("  -v         verbose mode (output all pairs, not just matches)\n")
        e.write("\nDefault thresholds (NGSCheckMate-inspired):\n")
        e.write("  r >= 0.95  : Matched (same individual or technical replicates)\n")
        e.write("  r >= 0.80  : Possibly related (siblings, parent-child)\n")
        e.write("  r <  0.80  : Unrelated\n")
        e.write("\nDepth-dependent thresholds (with -P):\n")
        e.write("  depth > 10 : High confidence matching\n")
        e.write("  depth 5-10 : Medium confidence\n")
        e.write("  depth 2-5  : Lower confidence\n")
        e.write("  depth < 2  : Very low confidence\n")
        return 1

    minfo("main", f"Loading correlation matrix from {corr_fn}...")
    try:
        names, corr = read_corr_matrix(corr_fn)
    except (OSError, ValueError):
        sys.stderr.write("Error: failed to load correlation matrix\n")
        return 1
    minfo("main", f"Loaded {len(names)} samples")

    depths = [0.0] * len(names)
    has_depth = False
    if use_predefined_model and pos:
        minfo("main", "Loading depth information from VAF files...")
        n_loaded = 0
        for i in range(min(len(names), len(pos))):
            d = None
            try:
                d = read_vaf_avg_depth(pos[i])
            except OSError:
                sys.stderr.write(f"Warning: could not open {pos[i]} for depth info\n")
            if d is not None:
                depths[i] = d
                n_loaded += 1
        if n_loaded > 0:
            minfo("load_depth_info", f"Loaded depth info for {n_loaded} samples")
            has_depth = True
        else:
            sys.stderr.write(
                "Warning: -P flag used but no depth info loaded, using simple threshold\n"
            )
            use_predefined_model = False
        if has_depth:
            minfo(
                "main",
                f"Using NGSCheckMate predefined model ({'family' if family_mode else 'non-family'} mode)",
            )

    if train_fn:
        minfo("main", "Calculating threshold from training data...")
        threshold = calculate_optimal_threshold(names, corr, train_fn)

    try:
        out_fp = open(out_fn, "w")
    except OSError:
        sys.stderr.write("Error: failed to open output file\n")
        return 1
    if use_predefined_model:
        minfo("main", "Classifying matches using predefined model...")
    else:
        minfo("main", f"Classifying matches with threshold {threshold:.4f}...")
    classify_matches(
        names, corr, depths, has_depth, threshold, out_fp,
        verbose_mode, family_mode, use_predefined_model,
    )
    out_fp.close()
    minfo("main", f"Results written to {out_fn}")
    return 0
