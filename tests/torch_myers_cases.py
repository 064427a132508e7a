"""Seeded Myers scan cases, numpy only, shared by
tests/test_torch_ed_vaf.py (the port's plain versions against the JAX
package on the CPU) and tests/test_torch_cuda.py (csrc/myers.cu against
the plain versions on the card).  Each names an edge of the kernel: the
word masks at m = 0, 1 and 32, alphabets of 1 and 20 codes with read
codes past them, reads of the tool's second length bucket, a batch of
empty reads, and W = 9 words (past the kernel's register form).  Each
is compared at its own max_e and at EVERY_LANE: at a small max_e most
lanes return 0, at EVERY_LANE each lane's count depends on its exact
best over every end position."""

import numpy as np

# name: (pattern lengths, n_alpha, n_words or None for one word, reads,
#        width L, read lengths (lo, hi), highest random read code, max_e)
MYERS_CASES = {
    "m_0_1_21_32": ([0, 1, 21, 32], 4, None, 40, 200, (0, 200), 4, 1),
    "n_alpha_1": ([5, 21, 32], 1, None, 40, 150, (1, 150), 3, 1),
    "n_alpha_20": ([7, 20, 31], 20, None, 40, 150, (1, 150), 25, 0),
    "reads_1025_1500": ([21, 32], 4, None, 12, 4096, (1025, 1500), 4, 1),
    "zero_length_reads": ([5, 32], 4, None, 16, 1024, (0, 0), 4, 1),
    "multiword_w9": ([33, 97, 200, 288], 4, 9, 24, 400, (0, 400), 4, 2),
}
N_PATTERNS = 24
# a max_e past every lane's best (at most its pattern's length): every
# lane then returns its count of best end positions, and a zero-length
# read its 0 (best stays 0x3FFFFFFF)
EVERY_LANE = 1 << 29


def planted_batch(rng, n_reads, pat_lens, n_pat, n_alpha, width,
                  read_lens, code_max):
    """(pattern codes (P, Lp) uint8 with the 255 fill, pattern lengths
    (P,) int32, read codes (R, L) uint8 with the 255 fill past each
    read's end, read lengths (R,) int32): random codes below n_alpha in
    the patterns and up to code_max in the reads (past the alphabet: the
    catch-all), an exact or one-error copy of a pattern planted in every
    other read.  chip_smoke.py draws its Myers batches here too."""
    plen = np.array([pat_lens[i % len(pat_lens)] for i in range(n_pat)],
                    np.int32)
    pc = np.full((n_pat, max(1, max(pat_lens))), 255, np.uint8)
    for i, m in enumerate(plen):
        pc[i, :m] = rng.integers(0, n_alpha, m)
    lens = rng.integers(read_lens[0], read_lens[1] + 1,
                        n_reads).astype(np.int32)
    codes = rng.integers(0, code_max + 1, (n_reads, width)).astype(np.uint8)
    codes[np.arange(width)[None, :] >= lens[:, None]] = 255
    for r in range(0, n_reads, 2):
        i = int(rng.integers(0, n_pat))
        m = int(plen[i])
        if 0 < m < lens[r]:
            at = int(rng.integers(0, lens[r] - m + 1))
            codes[r, at:at + m] = pc[i, :m]
            if r % 4 == 2:
                j = at + m // 2
                codes[r, j] = (int(codes[r, j]) + 1) % (n_alpha + 1)
    return pc, plen, codes, lens


def myers_case(name, seed=0):
    """planted_batch's four arrays for the case, with its n_alpha,
    n_words and max_e."""
    pat_lens, n_alpha, n_words, n_reads, L, read_lens, code_max, max_e = \
        MYERS_CASES[name]
    rng = np.random.default_rng([seed, sorted(MYERS_CASES).index(name)])
    return (*planted_batch(rng, n_reads, pat_lens, N_PATTERNS, n_alpha, L,
                           read_lens, code_max), n_alpha, n_words, max_e)
