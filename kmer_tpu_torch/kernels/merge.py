"""Merge of two sorted int64 runs into a new one (merge path): the
two-plane stream ladder's merge.

Replaces, for biased int64 keys (kernels/keys.py), the bitonic merge
that the JAX package runs on the TPU (kmer_tpu/kernels/bitonic.py
`merge_sorted_halves`: `_xstage_kernel` stages, then `_merge_tile_kernel`)
and that kernels/bitonic.py `merge_sorted_halves_` ports.  The function
is the same, and it has one correct output: two ascending runs in, one
ascending run of both out.  See csrc/merge.cu for the design.

  merge_runs        the merge: csrc/merge.cu for CUDA tensors (two
                    launches, `merge_partition` then `merge_path`), the
                    plain version for CPU tensors
  merge_runs_plain  the plain version, the rank form of the same stable
                    merge: a[i] lands at i + #(b < a[i]), b[j] at
                    j + #(a <= b[j]), one scatter

Out of place: a and b are left as they are, and the output (and the
partition's splits) come from torch.empty here; the kernels allocate
nothing.  a and b are contiguous 1-D int64 tensors of any lengths,
either empty, on one device.
"""

from __future__ import annotations

import torch

from . import _build


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for x in (a, b):
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError("merge: need contiguous 1-D int64 tensors")
    if a.device != b.device:
        raise ValueError("merge: the runs lie on different devices")


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> None:
    _check(a, b)
    if not a.is_cuda:
        raise ValueError("merge: the kernels take CUDA tensors (merge_runs "
                         "takes CPU tensors too)")


# -- plain PyTorch versions ---------------------------------------------

def _positions_of_a(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where each lane of a lands in the stable merge (ties to a)."""
    return torch.arange(a.shape[0], device=a.device) + torch.searchsorted(
        b, a, right=False)


def merge_runs_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    pos_b = torch.arange(b.shape[0], device=b.device) + torch.searchsorted(
        a, b, right=True)
    out = a.new_empty(a.shape[0] + b.shape[0])
    out[torch.cat([_positions_of_a(a, b), pos_b])] = torch.cat([a, b])
    return out


def merge_partition_plain(a: torch.Tensor, b: torch.Tensor,
                          tile: int) -> torch.Tensor:
    """int64[ceil(n / tile) + 1]: for each output tile boundary
    d = min(t * tile, n), how many of the first d merged lanes come from
    a (the lanes of a that land before d)."""
    _check(a, b)
    n = a.shape[0] + b.shape[0]
    d = torch.clamp(torch.arange(0, -(-n // tile) + 1, device=a.device)
                    * tile, max=n)
    return torch.searchsorted(_positions_of_a(a, b), d, right=False)


# -- the CUDA kernels ---------------------------------------------------

def tile_lanes() -> int:
    """Output lanes of one merge_path block: the partition's tile."""
    return _build.library().ktt_merge_tile_lanes()


def merge_partition(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The split of every output tile boundary (merge_partition_plain
    at the kernel's tile) with the CUDA kernel."""
    _check_cuda(a, b)
    lib = _build.library()
    tile = lib.ktt_merge_tile_lanes()
    n = a.shape[0] + b.shape[0]
    splits = torch.empty(-(-n // tile) + 1, dtype=torch.int64,
                         device=a.device)
    rc = lib.ktt_merge_partition(a.data_ptr(), a.shape[0], b.data_ptr(),
                                 b.shape[0], splits.data_ptr(),
                                 _build.stream_of(a))
    _build.LAUNCHES["merge_partition"] += 1
    _build.check(rc, "merge_partition")
    return splits


def merge_path(a: torch.Tensor, b: torch.Tensor,
               splits: torch.Tensor) -> torch.Tensor:
    """The merge of a and b with the CUDA kernel, given merge_partition's
    splits; a + b must hold at least one lane."""
    _check_cuda(a, b)
    out = a.new_empty(a.shape[0] + b.shape[0])
    rc = _build.library().ktt_merge_path(
        a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
        splits.data_ptr(), out.data_ptr(), _build.stream_of(a))
    _build.LAUNCHES["merge_path"] += 1
    _build.check(rc, "merge_path")
    return out


def merge_runs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ascending merge of the ascending runs a and b, in a new
    tensor: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors."""
    _check(a, b)
    if not a.is_cuda:
        return merge_runs_plain(a, b)
    if a.shape[0] + b.shape[0] == 0:
        return a.new_empty(0)
    return merge_path(a, b, merge_partition(a, b))
