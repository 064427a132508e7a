"""Myers bit-vector approximate matching, the edlib equivalent (port of
kmer_tpu/kernels/myers.py).

The Hyyrö/Myers bit-parallel edit-distance scan in HW (infix) mode, the
edlib configuration of ed-vaf-counter (EDLIB_MODE_HW, EDLIB_TASK_LOC):
for every (read, pattern) pair, the best distance over all end positions
and the number of end positions reaching it (edlib's numLocations).
`myers_hw_counts` takes patterns of up to 32 bases, one 32-bit word a
pattern; `myers_hw_counts_multiword` takes longer ones, W words with
ripple carries between them.  `myers_hw_sums{,_multiword}` give the same
counts summed over the reads, int64 a pattern, added into a total the
caller keeps (ed-vaf-counter's per-file accumulator).  Each comes in
three forms, as kernels/table.py's resolve_slots does:

  *_plain    the JAX `lax.scan` over text positions as a Python loop of
             elementwise torch operations on the (reads x patterns)
             state, on the device of its inputs (the sums: the counts'
             `.sum(0, dtype=torch.int64)`)
  *_kernel   csrc/myers.cu on the card: each thread several patterns of
             one read, left-aligned and mask-free, state in registers for
             the whole read (W words for W <= 8; a wider W keeps its
             words in a scratch plane); the sum form adds the counts on
             the card, one atomic per (block, pattern)
  public     the kernel when a tensor lies on a CUDA device, the plain
             version for CPU tensors

Two choices of the plain loop, neither of which changes a count:

  * the loop stops at the batch's longest read, where JAX scans the
    whole padded width (1024 for 150 bp reads): steps past every read's
    end are no-ops under the `valid` mask;
  * steps before the batch's shortest read skip the mask, since every
    lane is valid there.

Bit vectors are uint32 values in int32 lanes (PyTorch has no uint32
arithmetic on the CPU): `&`, `|`, `^`, `~`, `<<` and the wrapping `+`
act on the same 32 bits; a right shift that must be logical is masked
(`(x >> 31) & 1`), and the multiword carry compares with the sign bit
flipped, which is the unsigned order.  `hw_counts_long_pattern` is a
verbatim copy of the JAX package's numpy oracle (uint64 words), for the
tests.
"""

from __future__ import annotations

import torch

from . import _build

_I32_MIN = -(1 << 31)
_BEST0 = 0x3FFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding uint32 values -> int32 lanes, same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of int32 lanes holding uint32 values."""
    return (a ^ _I32_MIN) < (b ^ _I32_MIN)


def _low_bits(n: torch.Tensor) -> torch.Tensor:
    """int32 masks of the low n bits (n in [0, 32]; 1 << 32 special-cased,
    as in JAX)."""
    n = n.to(torch.int64)
    return _i32(torch.where(n >= 32, 0xFFFFFFFF,
                            (1 << n.clamp(max=32)) - 1))


def _eq_tables(peq: torch.Tensor) -> torch.Tensor:
    """(256, P) int32 rows of Peq by read code: codes >= n_alpha (the
    catch-all and the 255 fill) match nothing, as JAX's n_alpha-way
    select leaves them 0."""
    tab = peq.new_zeros((256, peq.shape[0]))
    tab[:peq.shape[1]] = peq.T
    return tab


def build_peq(patterns_codes: torch.Tensor, pat_len: torch.Tensor,
              n_alpha: int = 4) -> torch.Tensor:
    """Peq bitmasks (P, n_alpha) int32: bit i set iff pattern[i] ==
    letter, for i < pat_len (myers.py:29-47).  Codes >= n_alpha never
    match."""
    P, Lp = patterns_codes.shape
    pos = torch.arange(Lp, device=patterns_codes.device)
    in_pat = pos[None, :] < pat_len.to(torch.int64)[:, None]
    masks = [torch.where((patterns_codes == c) & in_pat, 1 << pos, 0).sum(1)
             for c in range(n_alpha)]
    return _i32(torch.stack(masks, dim=1))


def _update(new, old, v):
    return new if v is None else torch.where(v, new, old)


def _score_best(score, new_score, best, cnt, v):
    """The masked score step and the running (best, count of ends at
    best) of myers.py:94-101."""
    score = _update(new_score, score, v)
    better = score < best
    same = score == best
    if v is not None:
        better &= v
        same &= v
    cnt = torch.where(better, 1, torch.where(same, cnt + 1, cnt))
    best = torch.where(better, score, best)
    return score, best, cnt


def _steps(reads_codes: torch.Tensor, read_len: torch.Tensor):
    """(t, column of codes as int64, valid mask or None) over the text
    positions up to the longest read."""
    R = reads_codes.shape[0]
    if R == 0:
        return
    lens = read_len.to(reads_codes.device)
    n_steps, all_valid = int(lens.max()), int(lens.min())
    cols = reads_codes.T.to(torch.int64)
    for t in range(n_steps):
        v = None if t < all_valid else (t < lens)[:, None]
        yield cols[t], v


def myers_hw_counts_plain(peq: torch.Tensor, pat_len: torch.Tensor,
                          reads_codes: torch.Tensor, read_len: torch.Tensor,
                          max_e: int) -> torch.Tensor:
    """Counts of optimal end locations per (read, pattern), patterns of
    up to 32 bases (myers.py:50-108).

    peq: (P, n_alpha) int32 from build_peq; pat_len: (P,) int
    reads_codes: (R, L) uint8; read_len: (R,) int
    Returns (R, P) int32: numLocations if the best distance <= max_e,
    else 0."""
    P = peq.shape[0]
    R = reads_codes.shape[0]
    dev = peq.device
    m = pat_len.to(dev, torch.int64)
    hibit = _i32(torch.where(m >= 1, 1 << (m - 1).clamp(min=0), 0))[None, :]
    full = _low_bits(m)[None, :]
    pv = full.expand(R, P).clone()
    mv = torch.zeros((R, P), dtype=torch.int32, device=dev)
    score = m.to(torch.int32)[None, :].expand(R, P).clone()
    best = torch.full((R, P), _BEST0, dtype=torch.int32, device=dev)
    cnt = torch.zeros((R, P), dtype=torch.int32, device=dev)
    tab = _eq_tables(peq)
    for c, v in _steps(reads_codes.to(dev), read_len):
        eq = tab[c]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        new_score = (score + ((ph & hibit) != 0).to(torch.int32)
                     - ((mh & hibit) != 0).to(torch.int32))
        ph2 = ph << 1
        new_pv = ((mh << 1) | ~(xv | ph2)) & full
        new_mv = ph2 & xv
        pv = _update(new_pv, pv, v)
        mv = _update(new_mv, mv, v)
        score, best, cnt = _score_best(score, new_score, best, cnt, v)
    return torch.where(best <= max_e, cnt, 0)


def build_peq_multiword(patterns_codes: torch.Tensor, pat_len: torch.Tensor,
                        n_alpha: int, n_words: int) -> torch.Tensor:
    """Multi-word Peq bitmasks (P, W, n_alpha) int32: bit i % 32 of word
    i // 32 set iff pattern[i] == letter (myers.py:111-131)."""
    P, Lp = patterns_codes.shape
    pos = torch.arange(Lp, device=patterns_codes.device)
    in_pat = pos[None, :] < pat_len.to(torch.int64)[:, None]
    word = pos // 32
    masks = []
    for c in range(n_alpha):
        hot = torch.where((patterns_codes == c) & in_pat, 1 << (pos % 32), 0)
        masks.append(torch.stack(
            [torch.where(word == w, hot, 0).sum(1) for w in range(n_words)],
            dim=1))
    return _i32(torch.stack(masks, dim=2))


def _shl1(x, w):
    """Word w of a W-word vector shifted left by one: the carry from
    word w - 1's top bit, a logical shift (HW mode: bit 0 of word 0 stays
    0, the free start in the text)."""
    if w == 0:
        return x[0] << 1
    return (x[w] << 1) | ((x[w - 1] >> 31) & 1)


def myers_hw_counts_multiword_plain(peq: torch.Tensor,
                                    pat_len: torch.Tensor,
                                    reads_codes: torch.Tensor,
                                    read_len: torch.Tensor, max_e: int,
                                    n_words: int) -> torch.Tensor:
    """myers_hw_counts for patterns longer than 32 bases (myers.py:
    134-233): W words a (read, pattern) lane, ((eq & pv) + pv) with a
    ripple carry from the low word up, the score from each pattern's top
    bit (word (m - 1) // 32, bit (m - 1) % 32).

    peq: (P, W, n_alpha) int32 from build_peq_multiword; pat_len: (P,)
    reads_codes: (R, L) uint8; read_len: (R,)
    Returns (R, P) int32: numLocations if best <= max_e, else 0."""
    W = n_words
    P = peq.shape[0]
    R = reads_codes.shape[0]
    dev = peq.device
    m = pat_len.to(dev, torch.int64)
    hw_word = (m - 1) // 32
    hb = ((m - 1) % 32).to(torch.int32)[None, :]
    wlo = torch.arange(W, device=dev) * 32
    mfull = _low_bits((m[:, None] - wlo[None, :]).clamp(0, 32))  # (P, W)
    full = [mfull[:, w][None, :] for w in range(W)]
    sel = [(hw_word == w)[None, :] for w in range(W)]
    pv = [f.expand(R, P).clone() for f in full]
    mv = [torch.zeros((R, P), dtype=torch.int32, device=dev)
          for _ in range(W)]
    score = m.to(torch.int32)[None, :].expand(R, P).clone()
    best = torch.full((R, P), _BEST0, dtype=torch.int32, device=dev)
    cnt = torch.zeros((R, P), dtype=torch.int32, device=dev)
    tabs = [_eq_tables(peq[:, w, :]) for w in range(W)]
    for c, v in _steps(reads_codes.to(dev), read_len):
        eq = [tab[c] for tab in tabs]
        xv = [eq[w] | mv[w] for w in range(W)]
        xh = []
        carry = torch.zeros((R, P), dtype=torch.int32, device=dev)
        for w in range(W):
            a = eq[w] & pv[w]
            s1 = a + pv[w]
            s = s1 + carry
            carry = (_ult(s1, a) | _ult(s, s1)).to(torch.int32)
            xh.append((s ^ pv[w]) | eq[w])
        ph = [mv[w] | ~(xh[w] | pv[w]) for w in range(W)]
        mh = [pv[w] & xh[w] for w in range(W)]
        inc = torch.zeros((R, P), dtype=torch.int32, device=dev)
        dec = torch.zeros((R, P), dtype=torch.int32, device=dev)
        for w in range(W):
            inc |= torch.where(sel[w], (ph[w] >> hb) & 1, 0)
            dec |= torch.where(sel[w], (mh[w] >> hb) & 1, 0)
        ph2 = [_shl1(ph, w) for w in range(W)]
        mh2 = [_shl1(mh, w) for w in range(W)]
        new_pv = [(mh2[w] | ~(xv[w] | ph2[w])) & full[w] for w in range(W)]
        new_mv = [ph2[w] & xv[w] for w in range(W)]
        pv = [_update(new_pv[w], pv[w], v) for w in range(W)]
        mv = [_update(new_mv[w], mv[w], v) for w in range(W)]
        score, best, cnt = _score_best(score, score + inc - dec, best, cnt,
                                       v)
    return torch.where(best <= max_e, cnt, 0)


REG_WORDS = 8  # csrc/myers.cu kRegWords: a wider W keeps pv, mv in scratch


def _check(name, peq, pat_len, reads_codes, read_len, n_words, max_e):
    """Raise ValueError on what csrc/myers.cu does not take: peq int32
    (P, n_alpha) for one word (n_words None) or (P, n_words, n_alpha),
    n_alpha <= 256; pat_len int32 (P,); reads uint8 (R, L); read_len
    int32 (R,); max_e an int32 (the plain version compares on int32
    lanes); every tensor on one CUDA device, contiguous.  The grid's
    limits (2^31 - 1 pattern tiles, 65,535 read blocks) and L < 2^31
    are the launcher's there: it refuses them with
    cudaErrorInvalidValue, on which the launch raises."""
    if (peq.dtype != torch.int32 or pat_len.dtype != torch.int32
            or reads_codes.dtype != torch.uint8
            or read_len.dtype != torch.int32):
        raise ValueError(f"{name}: need int32 peq, pat_len and read_len and "
                         f"uint8 read codes")
    if n_words is None:
        shape_ok = peq.dim() == 2
    else:
        shape_ok = peq.dim() == 3 and peq.shape[1] == n_words >= 1
    if (not shape_ok or pat_len.shape != peq.shape[:1]
            or reads_codes.dim() != 2
            or read_len.shape != reads_codes.shape[:1]):
        want = "n_alpha" if n_words is None else f"{n_words}, n_alpha"
        raise ValueError(f"{name}: need peq (P, {want}), pat_len (P,), "
                         f"read codes (R, L) and read_len (R,)")
    if peq.shape[-1] > 256:
        raise ValueError(f"{name}: at most 256 alphabet codes")
    if not -(1 << 31) <= max_e < 1 << 31:
        raise ValueError(f"{name}: max_e must fit in int32")
    ts = (peq, pat_len, reads_codes, read_len)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: the kernel takes CUDA tensors on one "
                         f"device ({name.removesuffix('_kernel')} takes CPU "
                         f"tensors too)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: need contiguous tensors")


def kernel_shape(R: int, P: int, n_alpha: int, n_words: int = 1,
                 sums: bool = False, device=None) -> dict:
    """The launch csrc/myers.cu makes for R reads x P patterns of n_words
    words on `device` (ktt_myers_shape): regs (1: myers_regs, 0:
    myers_scratch), scratch_bytes (the plane the caller allocates),
    patterns (a thread; a block for myers_scratch), reads_a_warp, grid_x,
    grid_y, smem (dynamic shared memory a block), blocks_per_sm,
    registers (a thread).  Launches nothing."""
    out = torch.zeros(9, dtype=torch.int64)
    with torch.cuda.device(device if device is not None else "cuda"):
        _build.check(_build.library().ktt_myers_shape(
            R, P, n_alpha, n_words, int(sums), out.data_ptr()), "myers")
    return dict(zip(("regs", "scratch_bytes", "patterns", "reads_a_warp",
                     "grid_x", "grid_y", "smem", "blocks_per_sm",
                     "registers"), out.tolist()))


def _scratch(R, P, n_alpha, n_words, sums, device):
    """The scratch plane the launch needs (None for the register form)."""
    nbytes = kernel_shape(R, P, n_alpha, n_words, sums,
                          device)["scratch_bytes"]
    return (torch.empty(nbytes // 4, dtype=torch.int32, device=device)
            if nbytes else None)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def myers_hw_counts_kernel(peq: torch.Tensor, pat_len: torch.Tensor,
                           reads_codes: torch.Tensor, read_len: torch.Tensor,
                           max_e: int) -> torch.Tensor:
    """myers_hw_counts_plain on the card (csrc/myers.cu ktt_myers): the
    same (R, P) int32 counts.  A read's steps stop at min(read_len, L);
    an empty batch launches nothing."""
    _check("myers_hw_counts_kernel", peq, pat_len, reads_codes, read_len,
           None, max_e)
    (R, L), (P, n_alpha) = reads_codes.shape, peq.shape
    out = torch.empty((R, P), dtype=torch.int32, device=peq.device)
    if out.numel():
        _build.launch("ktt_myers", "myers", peq, peq.data_ptr(),
                      pat_len.data_ptr(), reads_codes.data_ptr(),
                      read_len.data_ptr(), R, P, L, n_alpha, max_e,
                      out.data_ptr())
    return out


def myers_hw_counts_multiword_kernel(peq: torch.Tensor,
                                     pat_len: torch.Tensor,
                                     reads_codes: torch.Tensor,
                                     read_len: torch.Tensor, max_e: int,
                                     n_words: int) -> torch.Tensor:
    """myers_hw_counts_multiword_plain on the card (csrc/myers.cu
    ktt_myers_multiword): W = n_words words in registers up to REG_WORDS,
    above it (or past the block's shared memory) in a scratch plane of
    2 x W x R x P uint32 allocated here."""
    _check("myers_hw_counts_multiword_kernel", peq, pat_len, reads_codes,
           read_len, n_words, max_e)
    (R, L), (P, _, n_alpha) = reads_codes.shape, peq.shape
    out = torch.empty((R, P), dtype=torch.int32, device=peq.device)
    if out.numel():
        scratch = _scratch(R, P, n_alpha, n_words, False, peq.device)
        _build.launch("ktt_myers_multiword", "myers_multiword", peq,
                      peq.data_ptr(), pat_len.data_ptr(),
                      reads_codes.data_ptr(), read_len.data_ptr(), R, P, L,
                      n_alpha, n_words, max_e, _ptr(scratch),
                      out.data_ptr())
    return out


def _check_total(name, total, P, device):
    if (total.dtype != torch.int64 or total.shape != (P,)
            or total.device != device or not total.is_contiguous()):
        raise ValueError(f"{name}: need an int64 total of shape ({P},) on "
                         f"{device}, contiguous")


def myers_hw_sums_kernel(peq: torch.Tensor, pat_len: torch.Tensor,
                         reads_codes: torch.Tensor, read_len: torch.Tensor,
                         max_e: int, total: torch.Tensor) -> torch.Tensor:
    """myers_hw_counts_kernel summed over the reads and added into
    `total` (int64 (P,), on the card; returned): csrc/myers.cu
    ktt_myers_sums, one launch, no (R, P) plane and no host read."""
    _check("myers_hw_sums_kernel", peq, pat_len, reads_codes, read_len,
           None, max_e)
    (R, L), (P, n_alpha) = reads_codes.shape, peq.shape
    _check_total("myers_hw_sums_kernel", total, P, peq.device)
    if R and P:
        _build.launch("ktt_myers_sums", "myers", peq, peq.data_ptr(),
                      pat_len.data_ptr(), reads_codes.data_ptr(),
                      read_len.data_ptr(), R, P, L, n_alpha, max_e,
                      total.data_ptr())
    return total


def myers_hw_sums_multiword_kernel(peq: torch.Tensor, pat_len: torch.Tensor,
                                   reads_codes: torch.Tensor,
                                   read_len: torch.Tensor, max_e: int,
                                   n_words: int,
                                   total: torch.Tensor) -> torch.Tensor:
    """myers_hw_counts_multiword_kernel summed over the reads into
    `total` (csrc/myers.cu ktt_myers_multiword_sums)."""
    _check("myers_hw_sums_multiword_kernel", peq, pat_len, reads_codes,
           read_len, n_words, max_e)
    (R, L), (P, _, n_alpha) = reads_codes.shape, peq.shape
    _check_total("myers_hw_sums_multiword_kernel", total, P, peq.device)
    if R and P:
        scratch = _scratch(R, P, n_alpha, n_words, True, peq.device)
        _build.launch("ktt_myers_multiword_sums", "myers_multiword", peq,
                      peq.data_ptr(), pat_len.data_ptr(),
                      reads_codes.data_ptr(), read_len.data_ptr(), R, P, L,
                      n_alpha, n_words, max_e, _ptr(scratch),
                      total.data_ptr())
    return total


def myers_hw_sums_plain(peq, pat_len, reads_codes, read_len, max_e, total):
    """The plain twin of myers_hw_sums_kernel: the counts' int64 sum over
    the reads, added into total."""
    return total.add_(myers_hw_counts_plain(
        peq, pat_len, reads_codes, read_len, max_e).sum(0,
                                                        dtype=torch.int64))


def myers_hw_sums_multiword_plain(peq, pat_len, reads_codes, read_len,
                                  max_e, n_words, total):
    """The plain twin of myers_hw_sums_multiword_kernel."""
    return total.add_(myers_hw_counts_multiword_plain(
        peq, pat_len, reads_codes, read_len, max_e, n_words).sum(
            0, dtype=torch.int64))


def _on_card(*ts) -> bool:
    return any(t.is_cuda for t in ts)


def myers_hw_counts(peq: torch.Tensor, pat_len: torch.Tensor,
                    reads_codes: torch.Tensor, read_len: torch.Tensor,
                    max_e: int) -> torch.Tensor:
    """Counts of optimal end locations per (read, pattern), patterns of
    up to 32 bases (myers.py:50-108): the kernel when a tensor lies on a
    CUDA device, the plain version for CPU tensors.

    peq: (P, n_alpha) int32 from build_peq; pat_len: (P,) int32
    reads_codes: (R, L) uint8; read_len: (R,) int32
    Returns (R, P) int32: numLocations if the best distance <= max_e,
    else 0."""
    if _on_card(peq, pat_len, reads_codes, read_len):
        return myers_hw_counts_kernel(peq, pat_len, reads_codes, read_len,
                                      max_e)
    return myers_hw_counts_plain(peq, pat_len, reads_codes, read_len, max_e)


def myers_hw_counts_multiword(peq: torch.Tensor, pat_len: torch.Tensor,
                              reads_codes: torch.Tensor,
                              read_len: torch.Tensor, max_e: int,
                              n_words: int) -> torch.Tensor:
    """myers_hw_counts for patterns longer than 32 bases (myers.py:
    134-233): the kernel when a tensor lies on a CUDA device, the plain
    version for CPU tensors.

    peq: (P, W, n_alpha) int32 from build_peq_multiword; pat_len: (P,)
    int32; reads_codes: (R, L) uint8; read_len: (R,) int32
    Returns (R, P) int32: numLocations if best <= max_e, else 0."""
    if _on_card(peq, pat_len, reads_codes, read_len):
        return myers_hw_counts_multiword_kernel(peq, pat_len, reads_codes,
                                                read_len, max_e, n_words)
    return myers_hw_counts_multiword_plain(peq, pat_len, reads_codes,
                                           read_len, max_e, n_words)


def myers_hw_sums(peq: torch.Tensor, pat_len: torch.Tensor,
                  reads_codes: torch.Tensor, read_len: torch.Tensor,
                  max_e: int, total: torch.Tensor) -> torch.Tensor:
    """myers_hw_counts summed over the reads (int64 a pattern) and added
    into total, which is returned: the kernel when a tensor lies on a
    CUDA device, the plain version for CPU tensors."""
    if _on_card(peq, pat_len, reads_codes, read_len, total):
        return myers_hw_sums_kernel(peq, pat_len, reads_codes, read_len,
                                    max_e, total)
    return myers_hw_sums_plain(peq, pat_len, reads_codes, read_len, max_e,
                               total)


def myers_hw_sums_multiword(peq: torch.Tensor, pat_len: torch.Tensor,
                            reads_codes: torch.Tensor,
                            read_len: torch.Tensor, max_e: int,
                            n_words: int,
                            total: torch.Tensor) -> torch.Tensor:
    """myers_hw_counts_multiword summed over the reads into total: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_card(peq, pat_len, reads_codes, read_len, total):
        return myers_hw_sums_multiword_kernel(peq, pat_len, reads_codes,
                                              read_len, max_e, n_words,
                                              total)
    return myers_hw_sums_multiword_plain(peq, pat_len, reads_codes,
                                         read_len, max_e, n_words, total)


def hw_counts_long_pattern(pat_codes, reads_codes, read_len, max_e: int,
                           n_alpha: int = 4):
    """Host cross-check for patterns longer than 32 bases (the u32-lane
    kernel's word limit; edlib handles any length via multi-word
    vectors, edlib.cpp:412).  The same recurrence as myers_hw_counts
    over W = ceil(m/64) uint64 words with ripple carries, vectorized
    over reads with numpy — the per-text-position loop stays in Python
    but each step is a handful of (R,)-wide numpy ops.  The production
    long-pattern path is myers_hw_counts_multiword; this stays as the
    independent oracle for it (tests/test_myers.py).

    pat_codes: iterable of alphabet codes (>= n_alpha never matches).
    reads_codes: (R, L) uint8; read_len: (R,) lengths.
    Returns a list of R counts (numLocations if best <= max_e else 0).
    """
    import numpy as np

    m = len(pat_codes)
    W = (m + 63) // 64
    ONE = np.uint64(1)
    # peq per word: (W, n_alpha) uint64
    peq = np.zeros((W, n_alpha), np.uint64)
    for i, c in enumerate(pat_codes):
        if c < n_alpha:
            peq[i // 64, c] |= ONE << np.uint64(i % 64)
    last_bits = m - 64 * (W - 1)
    full_last = (
        np.uint64(0xFFFFFFFFFFFFFFFF)
        if last_bits == 64
        else (ONE << np.uint64(last_bits)) - ONE
    )
    hw, hb = (m - 1) // 64, np.uint64((m - 1) % 64)

    reads_codes = np.asarray(reads_codes, np.uint8)
    read_len = np.asarray(read_len, np.int64)
    R, L = reads_codes.shape
    pv = np.zeros((W, R), np.uint64)
    pv[:-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    pv[-1] = full_last
    mv = np.zeros((W, R), np.uint64)
    score = np.full(R, m, np.int64)
    best = np.full(R, 1 << 30, np.int64)
    cnt = np.zeros(R, np.int64)
    c63 = np.uint64(63)

    for t in range(int(read_len.max()) if R else 0):
        c = reads_codes[:, t]
        valid = t < read_len
        cc = np.minimum(c, n_alpha - 1)
        eq = np.where(c < n_alpha, peq[:, cc], np.uint64(0))  # (W, R)
        xv = eq | mv
        # (eq & pv) + pv with ripple carry across words
        xh = np.empty_like(pv)
        carry = np.zeros(R, np.uint64)
        for w in range(W):
            a = eq[w] & pv[w]
            s1 = a + pv[w]
            c1 = s1 < a
            s = s1 + carry
            c2 = s < s1
            carry = (c1 | c2).astype(np.uint64)
            xh[w] = (s ^ pv[w]) | eq[w]
        ph = mv | ~(xh | pv)
        mh = pv & xh
        inc = ((ph[hw] >> hb) & ONE).astype(np.int64)
        dec = ((mh[hw] >> hb) & ONE).astype(np.int64)
        new_score = score + inc - dec
        # shift left by one with cross-word carry (low bit of word 0 = 0,
        # as in the single-word kernel)
        ph2 = np.empty_like(ph)
        mh2 = np.empty_like(mh)
        ph2[0] = ph[0] << ONE
        mh2[0] = mh[0] << ONE
        for w in range(1, W):
            ph2[w] = (ph[w] << ONE) | (ph[w - 1] >> c63)
            mh2[w] = (mh[w] << ONE) | (mh[w - 1] >> c63)
        new_pv = mh2 | ~(xv | ph2)
        new_pv[-1] &= full_last
        new_mv = ph2 & xv
        v = valid
        pv = np.where(v, new_pv, pv)
        mv = np.where(v, new_mv, mv)
        score = np.where(v, new_score, score)
        better = v & (score < best)
        same = v & (score == best)
        cnt = np.where(better, 1, np.where(same, cnt + 1, cnt))
        best = np.where(better, score, best)
    return np.where(best <= max_e, cnt, 0).tolist()
