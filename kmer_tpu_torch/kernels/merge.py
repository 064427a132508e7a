"""Merge of two sorted runs into a new one (merge path): the stream
ladders' merge, for their three lane types.

Replaces the bitonic merges that the JAX package runs on the TPU
(kmer_tpu/kernels/bitonic.py `merge_sorted_halves`, `merge_sorted_halves1`
and `merge_sorted_halves3`: `_xstage_kernel*` stages, then a
`_merge_tile_kernel*`) and that kernels/bitonic.py ports stage by stage.
The function is the same, and it has one correct output: two ascending
runs in, one ascending run of both out.  See csrc/merge.cu for the
design.

  merge_runs         one key plane, biased int64 (kernels/keys.py, the
                     two-plane ladder) or int32 (the one-plane ladder at
                     k <= 15): csrc/merge.cu for CUDA tensors (two
                     launches, `merge_partition` then `merge_path`), the
                     plain version for CPU tensors
  merge_runs3        (int64 key, int64 lane index) lanes in lexicographic
                     order, two planes a run (the yak tap's ladder)
  merge_runs_plain   the plain version, the rank form of the same stable
                     merge: a[i] lands at i + #(b < a[i]), b[j] at
                     j + #(a <= b[j]), one scatter
  merge_runs3_plain  the plain version for (key, index) lanes: the
                     concatenation sorted by index, then stably by key

Out of place: the runs are left as they are, and the output (and the
partition's splits) come from torch.empty here; the kernels allocate
nothing.  Every plane is a contiguous 1-D tensor; the runs have any
lengths, either may be empty, and all lie on one device.  Launch counts
(kernels/_build.py LAUNCHES) carry the lane type's suffix, as the
bitonic kernels' do: none for int64, 1 for int32, 3 for (key, index).
"""

from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.int64: "", torch.int32: "1"}


def _check_plane(x: torch.Tensor, dtype, like: torch.Tensor) -> None:
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"merge: need contiguous 1-D {dtype} tensors")
    if x.device != like.device:
        raise ValueError("merge: the runs lie on different devices")


def _check(a: torch.Tensor, b: torch.Tensor) -> str:
    """The lane type's suffix of two one-plane runs."""
    if a.dtype not in _SUFFIX:
        raise ValueError("merge: need int64 or int32 runs")
    _check_plane(a, a.dtype, a)
    _check_plane(b, a.dtype, a)
    return _SUFFIX[a.dtype]


def _check3(key_a, idx_a, key_b, idx_b) -> None:
    for x in (key_a, idx_a, key_b, idx_b):
        _check_plane(x, torch.int64, key_a)
    if key_a.shape != idx_a.shape or key_b.shape != idx_b.shape:
        raise ValueError("merge: key and index planes differ in shape")


def _need_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError("merge: the kernels take CUDA tensors (merge_runs "
                         "and merge_runs3 take CPU tensors too)")


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


def _key_idx_order(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The stable (key, index) order of lanes: by index, then stably by
    key."""
    order = torch.sort(idx, stable=True).indices
    return order[torch.sort(key[order], stable=True).indices]


def merge_runs3_plain(key_a, idx_a, key_b, idx_b):
    _check3(key_a, idx_a, key_b, idx_b)
    key, idx = torch.cat([key_a, key_b]), torch.cat([idx_a, idx_b])
    order = _key_idx_order(key, idx)
    return key[order], idx[order]


def merge_partition_plain(a: torch.Tensor, b: torch.Tensor,
                          tile: int) -> torch.Tensor:
    """int64[ceil(n / tile) + 1]: for each output tile boundary
    d = min(t * tile, n), how many of the first d merged lanes come from
    a (the lanes of a that land before d)."""
    _check(a, b)
    return _splits_plain(_positions_of_a(a, b), b.shape[0], tile)


def merge_partition3_plain(key_a, idx_a, key_b, idx_b,
                           tile: int) -> torch.Tensor:
    """merge_partition_plain in the (key, index) order (identical lanes
    of a and b: a's first, as the stable sorts leave them)."""
    _check3(key_a, idx_a, key_b, idx_b)
    order = _key_idx_order(torch.cat([key_a, key_b]),
                           torch.cat([idx_a, idx_b]))
    pos_a = torch.nonzero(order < key_a.shape[0]).squeeze(1)
    return _splits_plain(pos_a, key_b.shape[0], tile)


def _splits_plain(pos_a: torch.Tensor, nb: int, tile: int) -> torch.Tensor:
    n = pos_a.shape[0] + nb
    d = torch.clamp(torch.arange(0, -(-n // tile) + 1, device=pos_a.device)
                    * tile, max=n)
    return torch.searchsorted(pos_a, d, right=False)


# -- the CUDA kernels ---------------------------------------------------

def tile_lanes(dtype=torch.int64) -> int:
    """Output lanes of one merge_path block for one-plane runs of
    `dtype`: the partition's tile."""
    return getattr(_build.library(), f"ktt_merge_tile_lanes{_SUFFIX[dtype]}")()


def tile_lanes3() -> int:
    """tile_lanes for (key, index) runs."""
    return _build.library().ktt_merge_tile_lanes3()


def _new_splits(n: int, tile: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(-(-n // tile) + 1, dtype=torch.int64,
                       device=like.device)


def merge_partition(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The split of every output tile boundary (merge_partition_plain
    at the kernel's tile) with the CUDA kernel."""
    sfx = _check(a, b)
    _need_cuda(a)
    splits = _new_splits(a.shape[0] + b.shape[0], tile_lanes(a.dtype), a)
    _build.launch(f"ktt_merge_partition{sfx}", f"merge_partition{sfx}", a,
                  a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
                  splits.data_ptr())
    return splits


def merge_path(a: torch.Tensor, b: torch.Tensor,
               splits: torch.Tensor) -> torch.Tensor:
    """The merge of a and b with the CUDA kernel, given merge_partition's
    splits; a + b must hold at least one lane."""
    sfx = _check(a, b)
    _need_cuda(a)
    out = a.new_empty(a.shape[0] + b.shape[0])
    _build.launch(f"ktt_merge_path{sfx}", f"merge_path{sfx}", a,
                  a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
                  splits.data_ptr(), out.data_ptr())
    return out


def merge_partition3(key_a, idx_a, key_b, idx_b) -> torch.Tensor:
    """merge_partition in the (key, index) order."""
    _check3(key_a, idx_a, key_b, idx_b)
    _need_cuda(key_a)
    splits = _new_splits(key_a.shape[0] + key_b.shape[0], tile_lanes3(),
                         key_a)
    _build.launch("ktt_merge_partition3", "merge_partition3", key_a,
                  key_a.data_ptr(), idx_a.data_ptr(), key_a.shape[0],
                  key_b.data_ptr(), idx_b.data_ptr(), key_b.shape[0],
                  splits.data_ptr())
    return splits


def merge_path3(key_a, idx_a, key_b, idx_b, splits: torch.Tensor):
    """The (key, index) merge with the CUDA kernel, given
    merge_partition3's splits; at least one lane."""
    _check3(key_a, idx_a, key_b, idx_b)
    _need_cuda(key_a)
    n = key_a.shape[0] + key_b.shape[0]
    key, idx = key_a.new_empty(n), idx_a.new_empty(n)
    _build.launch("ktt_merge_path3", "merge_path3", key_a,
                  key_a.data_ptr(), idx_a.data_ptr(), key_a.shape[0],
                  key_b.data_ptr(), idx_b.data_ptr(), key_b.shape[0],
                  splits.data_ptr(), key.data_ptr(), idx.data_ptr())
    return key, idx


def merge_runs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ascending merge of the ascending runs a and b (both int64 or
    both int32), in a new tensor: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors."""
    _check(a, b)
    if not a.is_cuda:
        return merge_runs_plain(a, b)
    if a.shape[0] + b.shape[0] == 0:
        return a.new_empty(0)
    return merge_path(a, b, merge_partition(a, b))


def merge_runs3(key_a, idx_a, key_b, idx_b):
    """The merge of two (key, index)-ascending runs, in new (key, index)
    tensors: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors."""
    _check3(key_a, idx_a, key_b, idx_b)
    if not key_a.is_cuda:
        return merge_runs3_plain(key_a, idx_a, key_b, idx_b)
    if key_a.shape[0] + key_b.shape[0] == 0:
        return key_a.new_empty(0), idx_a.new_empty(0)
    return merge_path3(key_a, idx_a, key_b, idx_b,
                       merge_partition3(key_a, idx_a, key_b, idx_b))
