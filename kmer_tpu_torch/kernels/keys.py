"""The port's key layout: one biased int64 plane per 64-bit key.

The JAX package carries every 64-bit key as two uint32 planes (hi, lo)
compared lexicographically (kmer_tpu/kernels/u64.py).  PyTorch has no
`<`, `>>`, `sort` or `bincount` for uint32/uint64 on the CPU, so the
port stores key K as the int64 whose bits are K ^ 2^63.  Flipping the
top bit maps unsigned order onto signed order:

  * signed order of the biased plane == unsigned (hi, lo) order;
  * the all-ones sentinel (invalid lanes, padding) becomes INT64_MAX and
    sorts last, which the stream ladder relies on
    (kmer_tpu/table/stream_ladder.py);
  * keys with the top bit set (possible only at k=32) stay in order.

Conversions go to and from the JAX package's (hi, lo) uint32 numpy
planes; the tests use them at every boundary.

One-plane keys (k <= 15, kmer_tpu's one-plane compactor mode): data keys
are < 2^30, so the stream ladder keeps them as one int32 plane.  The
JAX one-plane sentinel is u32 0xFFFFFFFF, which as int32 is -1 and would
sort first; here it is INT32_MAX (`SENT32`), which sorts last.  `narrow`
and `widen` convert between the two layouts and keep the order.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = np.uint64(1 << 63)

# the all-ones u64 sentinel, biased
SENT = (1 << 63) - 1
# the one-plane sentinel
SENT32 = (1 << 31) - 1
BIAS_I64 = -(1 << 63)  # key ^ BIAS_I64 flips the top bit: biased <-> raw


def from_u64(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> biased int64 keys (numpy)."""
    return (np.asarray(keys, np.uint64) ^ _BIAS).view(np.int64)


def to_u64(biased: np.ndarray) -> np.ndarray:
    """Biased int64 keys -> uint64 keys (numpy)."""
    return np.ascontiguousarray(biased, np.int64).view(np.uint64) ^ _BIAS


def from_hi_lo(hi, lo, device=None) -> torch.Tensor:
    """(hi, lo) uint32 planes -> one biased int64 tensor."""
    k = (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)
    return torch.from_numpy(from_u64(k)).to(device)


def to_hi_lo(keys: torch.Tensor):
    """Biased int64 tensor -> (hi, lo) uint32 numpy planes."""
    k = to_u64(keys.detach().cpu().numpy())
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def narrow(keys: torch.Tensor) -> torch.Tensor:
    """Biased int64 keys below 2^31 - 1 (and SENT) -> one int32 plane:
    the key itself, SENT -> SENT32."""
    return torch.where(keys == SENT, SENT32,
                       keys ^ BIAS_I64).to(torch.int32)


def widen(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `narrow`: int32 plane -> biased int64 keys."""
    return torch.where(x == SENT32, SENT, x.to(torch.int64) ^ BIAS_I64)
