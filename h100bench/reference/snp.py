"""The SNP tools' files in plain numpy and PyTorch: snp-pattern-gen's
pattern rows (sites whose ref k-mer occurs once in the genome and alt
k-mer never) and vaf-counter's VAF file (ref/alt k-mer counts in the
reads, the first pattern owning a k-mer that two share)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import kmers

ACGT = "ACGT"


def codes_of(windows: np.ndarray) -> np.ndarray:
    """Canonical codes (int64) of (n, k) code windows (no N)."""
    k = windows.shape[1]
    w = windows.astype(np.int64)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    fwd = w @ pw
    rev = (3 - w[:, ::-1]) @ pw
    return np.minimum(fwd, rev)


def patterns(extra: dict, k: int, device) -> List[Tuple]:
    """The rows snp-pattern-gen writes: (site index, ref k-mer, alt
    k-mer, ref canonical code, alt canonical code), in BED order."""
    genome, bounds = extra["genome"], extra["bounds"]
    gpos = bounds[extra["site_chrom"]] + extra["site_pos"]
    flank = k // 2
    win = np.lib.stride_tricks.sliding_window_view(genome, k)[gpos - flank]
    alt_win = win.copy()
    alt_win[:, flank] = extra["alt"]
    ref_can, alt_can = codes_of(win), codes_of(alt_win)
    keys = torch.cat([kmers.window_keys(
        torch.from_numpy(genome[bounds[i]:bounds[i + 1]]).to(device)[None],
        k) for i in range(bounds.shape[0] - 1)])
    uniq, cnt = kmers.key_counts(keys)
    q = torch.from_numpy(np.concatenate([ref_can, alt_can])).to(device)
    got = kmers.count_of(uniq, cnt, q).cpu().numpy()
    n = ref_can.shape[0]
    keep = (got[:n] == 1) & (got[n:] == 0)
    text = lambda w: "".join(ACGT[c] for c in w)  # noqa: E731
    return [(int(i), text(win[i]), text(alt_win[i]), int(ref_can[i]),
             int(alt_can[i])) for i in np.flatnonzero(keep)]


def pattern_text(extra: dict, rows) -> str:
    """The pattern file's text (8 tab-separated columns a row)."""
    names, chrom, pos = (extra["chromosomes"], extra["site_chrom"],
                         extra["site_pos"])
    out = []
    for i, rk, ak, _r, _a in rows:
        out.append(f"{names[chrom[i]]}\t{pos[i]}\t{pos[i] + 1}\trs{i + 1}\t"
                   f"{ACGT[extra['ref'][i]]}\t{ACGT[extra['alt'][i]]}\t"
                   f"{rk}\t{ak}\n")
    return "".join(out)


def owners(rows) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct k-mer codes, the count slot 2*pattern + is_alt that owns
    each): the first pattern to name a k-mer owns it."""
    seen = {}
    for j, (_i, _rk, _ak, rc, ac) in enumerate(rows):
        seen.setdefault(rc, 2 * j)
        seen.setdefault(ac, 2 * j + 1)
    return (np.fromiter(seen.keys(), np.int64, len(seen)),
            np.fromiter(seen.values(), np.int64, len(seen)))


def vaf_text(extra: dict, rows, reads: np.ndarray, k: int, device,
             control=False) -> str:
    """vaf-counter's VAF file for one sample's reads; under `control`
    the reads' and the patterns' k-mers are both cut to 32-bit
    fingerprints."""
    codes, slot = owners(rows)
    got = kmers.query_counts(reads, k, device,
                             torch.from_numpy(codes).to(device),
                             control).cpu().numpy()
    counts = np.zeros(2 * len(rows), np.int64)
    counts[slot] = got
    names, chrom, pos = (extra["chromosomes"], extra["site_chrom"],
                         extra["site_pos"])
    total = int(counts.sum())
    avg = total / (len(rows) if rows else 1)
    out = [f"# Average depth: {avg:.2f}\n",
           "CHR\tPOS\tRSID\tREF\tALT\tREF_COUNT\tALT_COUNT\tTOTAL_COUNT\t"
           "VAF\n"]
    for j, (i, *_rest) in enumerate(rows):
        rc, ac = int(counts[2 * j]), int(counts[2 * j + 1])
        tot = rc + ac
        vaf = ac / tot if tot > 0 else 0.0
        out.append(f"{names[chrom[i]]}\t{pos[i]}\trs{i + 1}\t"
                   f"{ACGT[extra['ref'][i]]}\t{ACGT[extra['alt'][i]]}\t"
                   f"{rc}\t{ac}\t{tot}\t{vaf:.4f}\n")
    return "".join(out)
