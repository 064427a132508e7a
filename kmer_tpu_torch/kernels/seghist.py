"""Segment-length histogram over sorted keys (port of
kmer_tpu/kernels/seghist.py `segment_bins_sorted` and the histogram that
kmer_tpu/table/compactor.py:176-217 `_hist_impl_tpu` makes of its bins).

Over sorted biased int64 keys (sentinels last), each segment (maximal
run of one key) has a total: its lane count, or the sum of its weights
(uint32 bits in int32 lanes) mod 2^32, read as uint32 as the JAX
package's XLA histogram reads it (compactor.py:250-267 `_hist_xla_core`;
the Pallas kernel's int32 sum, seghist.py:105, would drop a total in
[2^31, 2^32)).  With bins_cfg = (n_bins, max_count, min_keep):

  segment_bins_sorted_plain   the TPU kernel's per-lane form: lane i
                              holds the bin of the segment that ENDED at
                              lane i-1 (0 below min_keep, where no
                              segment ends, or for the sentinel's), else
                              min(total, max_count, n_bins - 1), as uint8
                              (n_bins <= 256) or int16; the still-open
                              final run comes back as final = int64[2]
                              (last key, run length).
  segment_hist_sorted         the histogram itself: (hist int64[n_bins],
                              n_distinct int64 0-dim), bin 0 zero, the
                              final run added unless its key is the
                              sentinel; n_distinct = hist[1:].sum().

`segment_hist_sorted` launches csrc/seghist.cu (one pass over the keys,
then a small stitch across blocks) for CUDA tensors and runs
`segment_hist_sorted_plain` (the per-lane form, `bincount`, then the
final-run fold) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .keys import SENT

BinsCfg = Tuple[int, Optional[int], int]


def _bins_dtype(n_bins: int) -> torch.dtype:
    return torch.uint8 if n_bins <= 256 else torch.int16


def _check(keys: torch.Tensor, weights: Optional[torch.Tensor],
           bins_cfg: BinsCfg) -> None:
    n_bins, max_count, min_keep = bins_cfg
    if keys.dtype != torch.int64 or keys.dim() != 1 or keys.shape[0] == 0:
        raise ValueError("segment_hist_sorted: need a non-empty 1-D int64 "
                         "key tensor")
    if weights is not None and (weights.dtype != torch.int32
                                or weights.shape != keys.shape
                                or weights.device != keys.device):
        raise ValueError("segment_hist_sorted: weights must be int32 like "
                         "keys")
    if not 1 <= n_bins <= 1 << 15 or min_keep < 1 or (
            max_count is not None and not 1 <= max_count < 1 << 31):
        raise ValueError("segment_hist_sorted: bins_cfg out of range")


def segment_bins_sorted_plain(keys: torch.Tensor,
                              weights: Optional[torch.Tensor],
                              bins_cfg: BinsCfg):
    n_bins, max_count, min_keep = bins_cfg
    n = keys.shape[0]
    prev = torch.cat([keys.new_full((1,), SENT), keys[:-1]])
    starts = keys != prev
    v = (weights.to(torch.int64) if weights is not None
         else torch.ones(n, dtype=torch.int64, device=keys.device))
    csum = torch.cumsum(v, 0)
    pos = torch.arange(n, device=keys.device)
    # the run carried in before lane 0 has length 0, so lanes ahead of
    # the first start sum from lane 0 like a segment starting there
    start_pos = torch.cummax(torch.where(starts, pos, 0), 0).values
    run = (csum - (csum - v)[start_pos]) & 0xFFFFFFFF  # the uint32 total
    prev_run = torch.cat([run.new_zeros(1), run[:-1]])
    emit = torch.where(starts & (prev != SENT), prev_run, 0)
    ok = emit >= min_keep
    if max_count is not None:
        emit = torch.clamp(emit, max=max_count)
    bins = torch.where(ok, torch.clamp(emit, max=n_bins - 1), 0)
    final = torch.stack([keys[-1], run[-1]])
    return bins.to(_bins_dtype(n_bins)), final


def segment_hist_sorted_plain(keys: torch.Tensor,
                              weights: Optional[torch.Tensor],
                              bins_cfg: BinsCfg):
    """(hist int64[n_bins], n_distinct int64 0-dim) in plain PyTorch:
    the per-lane bins, an integer bincount (exact at any size; the JAX
    package's f32 one-hot product, segops.py:62-96, is for the TPU's
    MXU), bin 0 cleared, then the open final run (compactor.py:206-216)."""
    _check(keys, weights, bins_cfg)
    n_bins, max_count, min_keep = bins_cfg
    bins, final = segment_bins_sorted_plain(keys, weights, bins_cfg)
    hist = torch.bincount(bins, minlength=n_bins)
    hist[0] = 0
    fin_key, fin_len = final.tolist()
    if fin_key != SENT and fin_len >= min_keep:
        if max_count is not None:
            fin_len = min(fin_len, max_count)
        hist[min(fin_len, n_bins - 1)] += 1
    return hist, hist[1:].sum()


def segment_hist_sorted(keys: torch.Tensor, weights: Optional[torch.Tensor],
                        bins_cfg: BinsCfg):
    """(hist, n_distinct): the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if not keys.is_cuda:
        return segment_hist_sorted_plain(keys, weights, bins_cfg)
    _check(keys, weights, bins_cfg)
    n_bins, max_count, min_keep = bins_cfg
    lib = _build.library()
    keys = keys.contiguous()
    w = weights.contiguous() if weights is not None else None
    n = keys.shape[0]
    n_tiles = -(-n // lib.ktt_seghist_tile_lanes())
    out = torch.zeros(n_bins + 1, dtype=torch.int64, device=keys.device)
    scratch = torch.empty(3 * n_tiles, dtype=torch.int32, device=keys.device)
    _build.launch(
        "ktt_seghist", "seghist", keys, keys.data_ptr(),
        w.data_ptr() if w is not None else None, n, n_bins,
        -1 if max_count is None else max_count, min_keep, out.data_ptr(),
        scratch.data_ptr())
    return out[:n_bins], out[n_bins]
