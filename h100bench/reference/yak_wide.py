"""yak-count with a bloom filter (-b) of any size, in plain PyTorch: the
1023 histogram rows of the keys seen twice or more (counts saturated at
1023), and the `[M` lines of both passes, for one read set counted in
both passes (two-file yak-count given one file under two names, as
hifiasm's trio recipe gives it).

The semantics are reference/yak.py's: pass 1 admits a k-mer at its
first occurrence when the blocked bloom already holds all its probe
bits (a false positive), else at its second; one `[M] processed ...`
line a reader batch gives the running count of admitted distinct
k-mers; pass 2 reads the same batches, inserts nothing and repeats the
total; the shrink keeps the k-mers whose pass-2 count is 2 or more, so
the histogram is that of every k-mer seen twice.  A probe bit is set
before a first occurrence exactly when an earlier first occurrence
probes it, or the same key's earlier probe (a key that probes one bit
twice), so each probe entry is set iff it is not the first of its bit in
(lane, probe) order.

reference/yak.py finds those entries by sorting bit << 32 | first lane,
which holds bits below 2^31 only.  Here the entries are laid out in
(first lane, probe) order and sorted stably by the bit alone, so a bit
index and a lane may each take 63 bits: right for a 2^37-bit bloom and
lanes near 2^30.  The control is the bloom clamped to 2^31 bits, what an
engine that clamps there admits.
"""

from __future__ import annotations

import torch

from . import kmers
from .yak import N_BINS, batches, hash64, probe_bits

CLAMP_SHIFT = 31  # the control's bloom, log2 bits


def first_setters(ukeys: torch.Tensor, l1: torch.Tensor, pre: int,
                  bf_shift: int, n_hash: int) -> torch.Tensor:
    """Per distinct hashed key (ukeys, first lanes l1): all its probe
    bits were set before its first occurrence (a false positive)."""
    order = torch.argsort(l1)  # keys by first occurrence
    ent = torch.stack(probe_bits(ukeys[order], pre, bf_shift, n_hash), 1)
    s, pos = torch.sort(ent.reshape(-1), stable=True)
    later = torch.zeros_like(s, dtype=torch.bool)
    later[pos[1:]] = s[1:] == s[:-1]
    fp = torch.empty_like(order, dtype=torch.bool)
    fp[order] = later.view(-1, n_hash).all(1)
    return fp


def expected(reads, k: int, pre: int, bf_shift: int, n_hash: int,
             chunk: int, device, control=False) -> str:
    """stdout then the `[M` lines of `yak-count -k k -b bf_shift` over
    reads (an (n, L) uint8 code array) in both passes; under `control`
    the bloom is clamped to 2^31 bits."""
    if control:
        bf_shift = min(bf_shift, CLAMP_SHIFT)
    h = hash64(kmers.reads_keys(reads, k, device), k)
    hs, order = torch.sort(h, stable=True)  # lanes rise within a key
    del h
    first = torch.ones_like(hs, dtype=torch.bool)
    first[1:] = hs[1:] != hs[:-1]
    starts = torch.nonzero(first).flatten()
    del first
    counts = torch.diff(torch.cat([starts, starts.new_tensor(
        [hs.shape[0]])]))
    ukeys, l1 = hs[starts], order[starts]
    l2 = torch.where(counts > 1,
                     order[(starts + 1).clamp(max=hs.shape[0] - 1)],
                     torch.full_like(starts, -1))
    del hs, order, starts
    fp = first_setters(ukeys, l1, pre, bf_shift, n_hash)
    admit = torch.where(fp, l1, l2)  # -1: never admitted
    del ukeys, l1, l2, fp
    sizes = batches(reads, k, chunk, device)
    ends = torch.tensor(sizes, device=device)[:, 1].cumsum(0)
    which = torch.searchsorted(ends, admit[admit >= 0], right=True)
    per = torch.bincount(which, minlength=len(sizes)).cumsum(0).tolist()
    keep = counts[counts >= 2]
    lines = [f"[M] processed {n} sequences; {per[i]} distinct k-mers in "
             f"the hash table\n" for i, (n, _l) in enumerate(sizes)]
    lines += [f"[M] processed {n} sequences; {per[-1]} distinct k-mers in "
              f"the hash table\n" for n, _l in sizes]
    lines.append(f"[M::main] {keep.shape[0]} distinct k-mers after "
                 f"shrinking\n")
    return kmers.hist_rows(keep, N_BINS) + "".join(lines)
