"""yak-count on one file with a bloom filter (-b), in plain PyTorch: the
1023 histogram rows of the keys seen twice or more (counts saturated at
1023), and the `[M` lines of both passes.

Pass 1 admits a k-mer into the table at its first occurrence when the
blocked bloom filter already holds all its probe bits (a false
positive), else at its second occurrence; one `[M] processed ...` line
a reader batch (reads of k bases or more until they sum to the chunk
size) gives the running count of admitted distinct k-mers.  Pass 2
re-reads the same batches and admits nothing, so its lines repeat the
total; the shrink keeps the k-mers seen twice or more.

The bloom (one of 2^(b - pre) bits a prefix subtable, 512-bit blocks,
n_hash double-hashing probes in the k-mer's block, keyed by yak's
invertible hash of the canonical code) is test-and-set lane by lane in
read order.  Its verdicts follow without a loop: a probe bit is set
before a lane exactly when a k-mer whose first occurrence is earlier
probes it, so a first occurrence finds all its bits set exactly when
none of its probe entries is the earliest of its bit.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import kmers

BLK_SHIFT = 9
N_BINS = 1024  # yak's 10 counter bits: counts saturate at 1023


def hash64(key: torch.Tensor, k: int) -> torch.Tensor:
    """yak's (and kc's) invertible integer hash of 2k-bit codes, k <= 31
    (kc-c4.c:40-50)."""
    mask = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    return (key + (key << 31)) & mask


def probe_bits(h: torch.Tensor, pre: int, bf_shift: int, n_hash: int
               ) -> List[torch.Tensor]:
    """The bloom's global bit index of each probe of hashed keys h."""
    local = bf_shift - pre
    xs = local - BLK_SHIFT
    blk_mask = (1 << BLK_SHIFT) - 1
    sub = h & ((1 << pre) - 1)
    x = h >> pre
    blk = x & ((1 << min(xs, 32)) - 1)
    h1 = (x >> xs) & blk_mask
    h2 = (x >> local) & blk_mask
    h2 = torch.where((h2 & 31) == 0, (h2 + 1) & blk_mask, h2)
    base = (sub << local) + (blk << BLK_SHIFT)
    out, z = [], h1
    for _ in range(n_hash):
        out.append(base + z)
        z = (z + h2) & blk_mask
    return out


def batches(reads: np.ndarray, k: int, chunk: int, device):
    """(reads, valid k-mer lanes) of each reader batch: reads of k bases
    or more (all of them here: one length) until their lengths sum to
    `chunk` or more."""
    n, length = reads.shape
    per = -(-chunk // length)
    lanes = torch.cat([kmers.valid_windows(torch.from_numpy(
        reads[lo:lo + kmers.READS_A_CHUNK]).to(device), k)
        for lo in range(0, n, kmers.READS_A_CHUNK)])
    cum = torch.cat([lanes.new_zeros(1), lanes.cumsum(0)])
    bounds = list(range(0, n, per)) + [n]
    return [(b - a, int(cum[b] - cum[a]))
            for a, b in zip(bounds, bounds[1:])]


def expected(reads: np.ndarray, k: int, pre: int, bf_shift: int,
             n_hash: int, chunk: int, device, control=False) -> str:
    """stdout then the `[M` lines of `yak-count -k k -b bf_shift` on
    reads; under `control` the k-mers are cut to 32-bit fingerprints."""
    keys = kmers.reads_keys(reads, k, device, control=False)
    h = hash64(keys, k)
    del keys
    if control:
        h = kmers.fingerprint(h)
    lane = torch.arange(h.shape[0], device=device)
    hs, order = torch.sort(h, stable=True)  # lanes rise within a key
    del h
    first = torch.ones_like(hs, dtype=torch.bool)
    first[1:] = hs[1:] != hs[:-1]
    starts = torch.nonzero(first).flatten()
    counts = torch.diff(torch.cat([starts, starts.new_tensor(
        [hs.shape[0]])]))
    ukeys, l1 = hs[starts], lane[order[starts]]
    l2 = torch.where(counts > 1,
                     lane[order[(starts + 1).clamp(max=hs.shape[0] - 1)]],
                     torch.full_like(starts, -1))
    del hs, order, first, lane
    probes = probe_bits(ukeys, pre, bf_shift, n_hash)
    entry = torch.cat([(b << 32) | l1 for b in probes])
    s, pos = torch.sort(entry)
    preset = torch.zeros_like(s, dtype=torch.bool)
    preset[pos[1:]] = (s[1:] >> 32) == (s[:-1] >> 32)
    fp = preset.view(n_hash, -1).all(0)
    del entry, s, pos, preset, probes
    admit = torch.where(fp, l1, l2)  # -1: never admitted
    ends = []
    tot_lanes = 0
    sizes = batches(reads, k, chunk, device)
    for _n, n_lanes in sizes:
        tot_lanes += n_lanes
        ends.append(tot_lanes)
    ends_t = torch.tensor(ends, device=device)
    which = torch.searchsorted(ends_t, admit[admit >= 0], right=True)
    per = torch.bincount(which, minlength=len(ends)).cumsum(0).tolist()
    keep = counts[counts >= 2]
    lines = [f"[M] processed {n} sequences; {per[i]} distinct k-mers in "
             f"the hash table\n" for i, (n, _l) in enumerate(sizes)]
    lines += [f"[M] processed {n} sequences; {per[-1]} distinct k-mers in "
              f"the hash table\n" for n, _l in sizes]
    lines.append(f"[M::main] {keep.shape[0]} distinct k-mers after "
                 f"shrinking\n")
    return kmers.hist_rows(keep, N_BINS) + "".join(lines)
