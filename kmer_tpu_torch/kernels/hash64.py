"""The reference counters' invertible 64-bit hash on int64 tensors (port
of kmer_tpu/kernels/hash64.py:21-47), and the count table's slot mix
`slot_mix32` (:50-64).

hash64(key, mask) with mask = 2^(2k) - 1 for k <= 31.  Every value stays
below 2^62, so int64 arithmetic never overflows and the arithmetic `>>`
of int64 equals the logical shift: each left-shifted term is masked
BEFORE the shift (only its low bits survive the final mask anyway), and
sums of two masked terms stay below 2^63.  At k=32 the mask is all ones
and the canonical key is always 0 (kmer_tpu/kernels/kmer.py:74-80), so
the only k=32 hash value is the constant HASH64_K32_ZERO.
"""

from __future__ import annotations

import torch


def hash64_int(key: int, mask_nbits: int) -> int:
    """Python-int hash64 (the C code on uint64_t, mod 2^64)."""
    m = ((1 << mask_nbits) - 1) & ((1 << 64) - 1)
    key = (~key + (key << 21)) & m
    key = key ^ key >> 24
    key = ((key + (key << 3)) + (key << 8)) & m
    key = key ^ key >> 14
    key = ((key + (key << 2)) + (key << 4)) & m
    key = key ^ key >> 28
    key = (key + (key << 31)) & m
    return key


# hash64(0) under the full 64-bit mask: every valid k=32 window's key
HASH64_K32_ZERO = hash64_int(0, 64)


def hash64(key: torch.Tensor, mask_nbits: int) -> torch.Tensor:
    """hash64 of int64 keys in [0, 2^mask_nbits), mask_nbits <= 62."""
    assert 0 < mask_nbits <= 62, mask_nbits
    m = (1 << mask_nbits) - 1

    def shl(x, s):
        return (x & (m >> s)) << s

    def add(a, b):
        return (a + b) & m

    key = add(m - key, shl(key, 21))   # (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = add(add(key, shl(key, 3)), shl(key, 8))
    key = key ^ (key >> 14)
    key = add(add(key, shl(key, 2)), shl(key, 4))
    key = key ^ (key >> 28)
    key = add(key, shl(key, 31))
    return key


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64: the product is
    taken in two 16-bit halves of x, so no int64 product passes 2^49."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) \
        & 0xFFFFFFFF


def slot_mix32(keys: torch.Tensor) -> torch.Tensor:
    """The count table's slot mix (kmer_tpu/kernels/hash64.py:50-64) of
    biased int64 keys (kernels/keys.py), as int64 values in [0, 2^32):
    two rounds of the murmur3 finalizer on the unbiased key's (hi, lo)
    uint32 halves.  The table's layout follows from it, so it equals the
    JAX package's bit for bit: uint32 arithmetic carried in int64,
    masked to 32 bits after every multiply."""
    raw = keys ^ (-(1 << 63))
    hi = (raw >> 32) & 0xFFFFFFFF
    x = (raw & 0xFFFFFFFF) ^ _mul32(hi, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)
