"""Host-side (numpy) sequence helpers for small k-mer sets (a copy of
kmer_tpu/utils/seq.py without `slot_mix32_np`, which serves only the
JAX package's table engines).

Used where the reference manipulates individual k-mers on the CPU
(snp-pattern-gen candidate generation, vaf-counter pattern-map build):
non-rolling encode/revcomp/canonical (the reference tools'
snp-pattern-gen.c:130-159, vaf-counter.c:117-146) and hash64.
"""

from __future__ import annotations

import numpy as np

# seq_nt4_table (kc-c1.c:12-29): A/a->0, C/c->1, G/g->2, T/t/U/u->3,
# everything else -> 4
SEQ_NT4_NP = np.full(256, 4, np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    SEQ_NT4_NP[ord(_ch)] = _code
    SEQ_NT4_NP[ord(_ch.lower())] = _code

U64_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def encode_kmer(seq: bytes, k: int) -> int:
    """2-bit encode; returns -1 (reference: UINT64_MAX) if any N.
    A sequence shorter than k also returns -1: the C encode_kmer
    (vaf-counter.c:117-126, snp-pattern-gen.c:130-141) walks into the
    NUL terminator, whose seq_nt4 code is 4 — so a too-short pattern
    k-mer is skipped, never an error."""
    if len(seq) < k:
        return -1
    kmer = 0
    for i in range(k):
        c = int(SEQ_NT4_NP[seq[i]])
        if c >= 4:
            return -1
        kmer = (kmer << 2) | c
    return kmer


def revcomp_kmer(kmer: int, k: int) -> int:
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | (3 - (kmer & 3))
        kmer >>= 2
    return rc


def canonical_kmer(kmer: int, k: int) -> int:
    rc = revcomp_kmer(kmer, k)
    return kmer if kmer < rc else rc


def hash64_np(key, mask) -> np.ndarray:
    """Vectorized reference hash64 (kc-c4.c:40-50) on numpy uint64."""
    key = np.asarray(key, np.uint64)
    mask = np.uint64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ key >> np.uint64(24)
        key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & mask
        key = key ^ key >> np.uint64(14)
        key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & mask
        key = key ^ key >> np.uint64(28)
        key = (key + (key << np.uint64(31))) & mask
    return key

