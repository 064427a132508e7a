"""Canonical k-mer keys of reads and their counts, in plain PyTorch."""

from __future__ import annotations

import numpy as np
import torch

# a 32-bit fingerprint of a key: the high half of key * this odd number
_FP_MUL = 0x9E3779B97F4A7C15 - (1 << 64)
READS_A_CHUNK = 1 << 20


def _ok(reads: torch.Tensor, k: int) -> torch.Tensor:
    """(n, L - k + 1): the windows of k bases that hold no N."""
    n, length = reads.shape
    bad = (reads > 3).to(torch.int32).cumsum(1, dtype=torch.int32)
    cum = torch.cat([bad.new_zeros((n, 1)), bad], 1)
    return (cum[:, k:] - cum[:, :length - k + 1]) == 0


def window_keys(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical codes (int64) of every window of k <= 31 bases that
    holds no N, read after read, over the rows of `reads`, (n, L) uint8
    codes (N = 4)."""
    n, length = reads.shape
    w = length - k + 1
    if w <= 0 or n == 0:
        return torch.empty(0, dtype=torch.int64, device=reads.device)
    c = reads.to(torch.int64) & 3
    fwd = torch.zeros((n, w), dtype=torch.int64, device=reads.device)
    rev = torch.zeros_like(fwd)
    for i in range(k):
        col = c[:, i:i + w]
        fwd = (fwd << 2) | col
        rev = rev | ((3 - col) << (2 * i))
    return torch.minimum(fwd, rev)[_ok(reads, k)]


def valid_windows(reads: torch.Tensor, k: int) -> torch.Tensor:
    """The number of windows without N in each read (int64)."""
    if reads.shape[1] < k:
        return torch.zeros(reads.shape[0], dtype=torch.int64,
                           device=reads.device)
    return _ok(reads, k).sum(1)


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    """The 32-bit fingerprint of each key (the control's lossy keys)."""
    return ((keys * _FP_MUL) >> 32) & 0xFFFFFFFF


def reads_keys(reads: np.ndarray, k: int, device, control=False):
    """The keys of every valid window of `reads` ((n, L) codes on the
    host), in blocks of rows; 32-bit fingerprints under `control`."""
    out = []
    for off in range(0, reads.shape[0], READS_A_CHUNK):
        block = torch.from_numpy(reads[off:off + READS_A_CHUNK]).to(device)
        keys = window_keys(block, k)
        out.append(fingerprint(keys) if control else keys)
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int64)


def query_counts(reads: np.ndarray, k: int, device, query: torch.Tensor,
                 control=False) -> torch.Tensor:
    """How often each query key (int64 codes, any order) occurs among the
    keys of `reads`, block by block of rows, so a sample of any size
    fits; under `control` reads' and queries' keys are both cut to
    32-bit fingerprints first."""
    if control:
        query = fingerprint(query)
    uq, inv = torch.unique(query, return_inverse=True)
    tally = torch.zeros(uq.shape[0], dtype=torch.int64, device=uq.device)
    if uq.numel() == 0:
        return tally[inv]
    for off in range(0, reads.shape[0], READS_A_CHUNK):
        block = torch.from_numpy(reads[off:off + READS_A_CHUNK]).to(device)
        keys = window_keys(block, k)
        if control:
            keys = fingerprint(keys)
        i = torch.searchsorted(uq, keys).clamp(max=uq.shape[0] - 1)
        tally += torch.bincount(i[uq[i] == keys], minlength=uq.shape[0])
    return tally[inv]


def key_counts(keys: torch.Tensor):
    """(distinct keys ascending, their counts)."""
    keys, _ = torch.sort(keys)
    return torch.unique_consecutive(keys, return_counts=True)


def hist_rows(counts: torch.Tensor, n_bins: int, lo: int = 1) -> str:
    """`i\\tdistinct` rows i = lo..n_bins-1, counts past the last bin in
    it: the kc-c4 (256 bins) and yak-count (1024) histogram text."""
    h = torch.bincount(counts.clamp(max=n_bins - 1), minlength=n_bins)
    h = h.cpu().tolist()
    return "".join(f"{i}\t{h[i]}\n" for i in range(lo, n_bins))


def count_of(sorted_keys: torch.Tensor, counts: torch.Tensor,
             query: torch.Tensor) -> torch.Tensor:
    """Count of each query key among distinct sorted keys (0 if absent)."""
    if sorted_keys.numel() == 0:
        return torch.zeros_like(query)
    i = torch.searchsorted(sorted_keys, query).clamp(
        max=sorted_keys.shape[0] - 1)
    return torch.where(sorted_keys[i] == query, counts[i],
                       torch.zeros_like(counts[i]))
