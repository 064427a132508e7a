"""Bitonic merge of two sorted halves (port of kmer_tpu/kernels/bitonic.py).

Off every path: the stream ladders merge with kernels/merge.py
(`merge_runs`, `merge_runs3`), and only chip_smoke.py still checks these
kernels and times them beside the merge path.  Three lane types, one per
JAX merge:

  merge_sorted_halves_    one biased int64 plane: the JAX two-plane
                          (hi, lo) merge (`merge_sorted_halves`)
  merge_sorted_halves1_   one int32 plane: the JAX one-plane merge of
                          keys < 2^31 (`merge_sorted_halves1`); the
                          sentinel is INT32_MAX (table/compactor.py)
  merge_sorted_halves3_   an (int64 key, int64 lane index) pair of planes
                          in lexicographic order: the JAX three-plane
                          (hi, lo, idx) merge (`merge_sorted_halves3`)

Reversing the second half makes the planes one bitonic sequence; stages
at strides n/2, n/4, ..., 1 then compare-exchange lane i with lane i ^ s
and keep the minimum where bit s of i is 0.  The result equals a sort of
the whole plane.  n must be a power of two (callers pad with sentinels).

Everything here works IN PLACE: the JAX package donates the concatenated
temporaries to its merge (bitonic.py:463-477) so their memory becomes
the output; here the caller's buffers are the output.

Each `merge_sorted_halves*_` runs csrc/bitonic.cu for CUDA tensors: one
`xstage*_` launch per stride >= the GPU tile, then one `merge_tiles*_`
launch for every lower stride.  For CPU tensors it runs its plain
version `merge_sorted_halves*_plain_`, built from `stage*_plain_`.
"""

from __future__ import annotations

import torch

from . import _build


def _check(x: torch.Tensor, dtype=torch.int64) -> int:
    n = x.shape[0]
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"bitonic: need a contiguous 1-D {dtype} tensor")
    if n < 2 or n & (n - 1):
        raise ValueError("bitonic: need power-of-two lanes")
    return n


def _check3(key: torch.Tensor, idx: torch.Tensor) -> int:
    n = _check(key)
    _check(idx)
    if idx.shape != key.shape or idx.device != key.device:
        raise ValueError("bitonic: key and index planes differ in shape "
                         "or device")
    return n


def _flip_second_half_(*planes) -> None:
    half = planes[0].shape[0] // 2
    for x in planes:
        x[half:] = x[half:].flip(0)


# -- plain PyTorch versions ---------------------------------------------

def stage_plain_(x: torch.Tensor, s: int) -> torch.Tensor:
    """One compare-exchange stage at stride s, in place (any integer
    dtype: the order is the tensor's own)."""
    v = x.view(-1, 2, s)
    a, b = v[:, 0], v[:, 1]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    a.copy_(lo)
    b.copy_(hi)
    return x


# the one-plane stage is the same min/max on an int32 plane
stage1_plain_ = stage_plain_


def stage3_plain_(key: torch.Tensor, idx: torch.Tensor, s: int):
    """One compare-exchange stage at stride s over (key, idx) lanes in
    lexicographic order, in place."""
    k, i = key.view(-1, 2, s), idx.view(-1, 2, s)
    ka, kb, ia, ib = k[:, 0], k[:, 1], i[:, 0], i[:, 1]
    swap = (kb < ka) | ((kb == ka) & (ib < ia))
    lo_k, hi_k = torch.where(swap, kb, ka), torch.where(swap, ka, kb)
    lo_i, hi_i = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
    ka.copy_(lo_k)
    kb.copy_(hi_k)
    ia.copy_(lo_i)
    ib.copy_(hi_i)
    return key, idx


def _merge_plain_(planes, n: int, stage) -> None:
    _flip_second_half_(*planes)
    s = n // 2
    while s:
        stage(*planes, s)
        s //= 2


def merge_sorted_halves_plain_(x: torch.Tensor) -> torch.Tensor:
    _merge_plain_((x,), _check(x), stage_plain_)
    return x


def merge_sorted_halves1_plain_(x: torch.Tensor) -> torch.Tensor:
    _merge_plain_((x,), _check(x, torch.int32), stage1_plain_)
    return x


def merge_sorted_halves3_plain_(key: torch.Tensor, idx: torch.Tensor):
    _merge_plain_((key, idx), _check3(key, idx), stage3_plain_)
    return key, idx


# -- the CUDA kernels ---------------------------------------------------

def tile_bits() -> int:
    """log2 of the int64 tile kernel's lanes."""
    return _build.library().ktt_merge_tile_bits()


def tile_bits1() -> int:
    """log2 of the int32 tile kernel's lanes."""
    return _build.library().ktt_merge_tile_bits1()


def tile_bits3() -> int:
    """log2 of the (key, index) tile kernel's lanes."""
    return _build.library().ktt_merge_tile_bits3()


def xstage_(x: torch.Tensor, stride: int) -> torch.Tensor:
    """One stage at `stride` with the CUDA kernel, in place."""
    n = _check(x)
    _build.launch("ktt_merge_xstage", "merge_xstage", x, x.data_ptr(), n,
                  stride)
    return x


def merge_tiles_(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Every stage at strides < 2^bits, tile by tile, with the CUDA
    kernel, in place."""
    n = _check(x)
    _build.launch("ktt_merge_tiles", "merge_tile", x, x.data_ptr(), n, bits)
    return x


def xstage1_(x: torch.Tensor, stride: int) -> torch.Tensor:
    n = _check(x, torch.int32)
    _build.launch("ktt_merge_xstage1", "merge_xstage1", x, x.data_ptr(), n,
                  stride)
    return x


def merge_tiles1_(x: torch.Tensor, bits: int) -> torch.Tensor:
    n = _check(x, torch.int32)
    _build.launch("ktt_merge_tiles1", "merge_tile1", x, x.data_ptr(), n, bits)
    return x


def xstage3_(key: torch.Tensor, idx: torch.Tensor, stride: int):
    n = _check3(key, idx)
    _build.launch("ktt_merge_xstage3", "merge_xstage3", key, key.data_ptr(),
                  idx.data_ptr(), n, stride)
    return key, idx


def merge_tiles3_(key: torch.Tensor, idx: torch.Tensor, bits: int):
    n = _check3(key, idx)
    _build.launch("ktt_merge_tiles3", "merge_tile3", key, key.data_ptr(),
                  idx.data_ptr(), n, bits)
    return key, idx


def _merge_cuda_(planes, n: int, max_bits: int, xstage, tiles) -> None:
    _flip_second_half_(*planes)
    log2n = n.bit_length() - 1
    bits = min(max_bits, log2n)
    for k in range(log2n - 1, bits - 1, -1):
        xstage(*planes, 1 << k)
    tiles(*planes, bits)


def merge_sorted_halves_(x: torch.Tensor) -> torch.Tensor:
    """Merge x's two ascending halves in place and return x: the CUDA
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return merge_sorted_halves_plain_(x)
    _merge_cuda_((x,), _check(x), tile_bits(), xstage_, merge_tiles_)
    return x


def merge_sorted_halves1_(x: torch.Tensor) -> torch.Tensor:
    """merge_sorted_halves_ for one int32 plane."""
    if not x.is_cuda:
        return merge_sorted_halves1_plain_(x)
    _merge_cuda_((x,), _check(x, torch.int32), tile_bits1(), xstage1_,
                 merge_tiles1_)
    return x


def merge_sorted_halves3_(key: torch.Tensor, idx: torch.Tensor):
    """merge_sorted_halves_ for (int64 key, int64 index) lanes in
    lexicographic order; returns (key, idx)."""
    if not key.is_cuda:
        return merge_sorted_halves3_plain_(key, idx)
    _merge_cuda_((key, idx), _check3(key, idx), tile_bits3(), xstage3_,
                 merge_tiles3_)
    return key, idx
