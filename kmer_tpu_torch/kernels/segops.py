"""Segment operations over sorted keys (port of kmer_tpu/kernels/segops.py).

Only `segment_starts` carries over: the JAX package's one-hot
`histogram_by_matmul` (segops.py:62-96) exists for the TPU's matrix
unit, and the port folds the histogram into its segment-histogram
kernel (kernels/seghist.py `segment_hist_sorted`; the plain twin counts
with an integer `torch.bincount`).
"""

from __future__ import annotations

import torch


def segment_starts(keys_sorted: torch.Tensor) -> torch.Tensor:
    """True where a new key segment begins (position 0 or key != prev)."""
    starts = torch.ones_like(keys_sorted, dtype=torch.bool)
    starts[1:] = keys_sorted[1:] != keys_sorted[:-1]
    return starts
