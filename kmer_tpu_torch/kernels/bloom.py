"""Blocked bloom filter geometry and probe indices (port of
kmer_tpu/kernels/bloom.py: `BLK_SHIFT`, `BloomSpec`, `_probe_indices`).

The probe math of the reference's yak_bf_insert: 512-bit blocks
(BLK_SHIFT 9), one bloom per prefix subtable (2^pre subtables of
2^(n_shift - pre) bits each, laid out one after another), a block picked
by the key's middle bits, and n_hashes double-hashing probes inside the
block (z += h2, with the (h2 & 31) == 0 adjustment).

Only the probe indices are needed on one device: the deferred admission
(pipeline/yak_admit.py) resolves the bloom's verdicts by sorting probe
entries, without a bits array.  The JAX `insert`, `insert_sequential`
and `test` serve two-file yak-count and are not ported yet.

Keys arrive biased (kernels/keys.py), so `probe_indices` un-biases them
first.  A key may then have its top bit set (k = 32), and `>>` on int64
is arithmetic, so every right shift is masked to the bits a logical
shift would keep.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .keys import BIAS_I64

BLK_SHIFT = 9  # 512-bit blocks
BLK_MASK = (1 << BLK_SHIFT) - 1


class BloomSpec(NamedTuple):
    pre: int  # prefix bits (subtable count = 2^pre)
    n_shift: int  # total bloom size = 2^n_shift bits across all subtables
    n_hashes: int
    # the mesh's per-device share of the subtables (kmer_tpu's BloomSpec);
    # 0 on one device
    owner_bits: int = 0


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def probe_indices(keys: torch.Tensor, spec: BloomSpec) -> List[torch.Tensor]:
    """Global bit indices (int64) of the n_hashes probes of each biased
    int64 key, lane for lane equal to kmer_tpu's `_probe_indices`."""
    k = keys ^ BIAS_I64
    local_shift = spec.n_shift - spec.pre  # per-subtable bloom bits
    xs = local_shift - BLK_SHIFT  # block index bits
    pre_idx = _shr(k & ((1 << spec.pre) - 1), spec.owner_bits)
    x = _shr(k, spec.pre)
    # the JAX block index is the low 32 bits of x, masked to xs bits
    blk = x & ((1 << min(xs, 32)) - 1)
    h1 = _shr(x, xs) & BLK_MASK
    h2 = _shr(x, local_shift) & BLK_MASK
    # avoid cycling over few bits
    h2 = torch.where((h2 & 31) == 0, (h2 + 1) & BLK_MASK, h2)
    base = (pre_idx << local_shift) + (blk << BLK_SHIFT)
    idxs = []
    z = h1
    for _ in range(spec.n_hashes):
        idxs.append(base + z)
        z = (z + h2) & BLK_MASK
    return idxs
