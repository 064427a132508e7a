"""Blocked bloom filter: geometry, probe indices and the bits array
(port of kmer_tpu/kernels/bloom.py).

The probe math of the reference's yak_bf_insert: 512-bit blocks
(BLK_SHIFT 9), one bloom per prefix subtable (2^pre subtables of
2^(n_shift - pre) bits each, laid out one after another), a block picked
by the key's middle bits, and n_hashes double-hashing probes inside the
block (z += h2, with the (h2 & 31) == 0 adjustment).

Storage is the JAX package's: one uint8 byte per bit (`make_bits`), so
that setting bits is an idempotent scatter and reading them a gather.
Single-file yak-count needs only the probe indices (the deferred
admission, pipeline/yak_admit.py, resolves the bloom's verdicts by
sorting probe entries); two-file yak-count gates pass 1 with `insert`
or, by default, `insert_sequential`, the reference's lane-by-lane
test-and-set.

Keys arrive biased (kernels/keys.py), so `probe_indices` un-biases them
first.  A key may then have its top bit set (k = 32), and `>>` on int64
is arithmetic, so every right shift is masked to the bits a logical
shift would keep.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from .keys import BIAS_I64, SENT

BLK_SHIFT = 9  # 512-bit blocks
BLK_MASK = (1 << BLK_SHIFT) - 1


class BloomSpec(NamedTuple):
    pre: int  # prefix bits (subtable count = 2^pre)
    n_shift: int  # total bloom size = 2^n_shift bits across all subtables
    n_hashes: int
    # the mesh's per-device share of the subtables (kmer_tpu's BloomSpec);
    # 0 on one device
    owner_bits: int = 0


def make_bits(spec: BloomSpec, device=None) -> torch.Tensor:
    """The zeroed bits array, one uint8 a bit: 2^(n_shift - owner_bits)
    bytes (bloom.py:63-72; at most 2^31, 2 GiB)."""
    assert spec.n_shift - spec.owner_bits <= 31, (
        "per-shard bloom limited to 2^31 bits (engines clamp -b via "
        "pipeline.yak._clamp_bf_shift)")
    assert BLK_SHIFT <= spec.n_shift - spec.pre, (
        "bloom smaller than one block per subtable")
    assert spec.owner_bits <= spec.pre
    return torch.zeros(1 << (spec.n_shift - spec.owner_bits),
                       dtype=torch.uint8, device=device)


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


def _all_set(bits: torch.Tensor, idxs, valid: torch.Tensor) -> torch.Tensor:
    """Per lane: every probe bit is set in `bits` (invalid lanes read
    bit 0 and come out False)."""
    ok = valid.clone()
    for ix in idxs:
        ok &= bits[torch.where(valid, ix, 0)] == 1
    return ok


def _set(bits: torch.Tensor, idxs, valid: torch.Tensor) -> None:
    """Set every probe bit of the valid lanes, in place.  An amax scatter
    is idempotent under duplicate indices; invalid lanes scatter 0 into
    bit 0, which leaves it as it was."""
    one = valid.to(torch.uint8)
    for ix in idxs:
        bits.scatter_reduce_(0, torch.where(valid, ix, 0), one, "amax")


def insert(bits: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
           spec: BloomSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test-and-set all probes (bloom.py:100-115).  Returns (bits,
    preset): preset[i] is True iff all n_hashes bits of lane i were set
    before this call (the `yak_bf_insert(...) == n_hash` gate).  `bits`
    is updated in place and returned."""
    idxs = probe_indices(keys, spec)
    preset = _all_set(bits, idxs, valid)
    _set(bits, idxs, valid)
    return bits, preset


def insert_sequential(bits: torch.Tensor, keys: torch.Tensor,
                      valid: torch.Tensor, spec: BloomSpec
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """insert() with the reference's sequential test-and-set
    (bloom.py:118-175): preset[i] is True iff every probe bit of lane i
    was set before the call OR by a strictly earlier lane of it.

    One sort of the probe entries by (bit, lane), as the int64 key
    bit << 32 | lane (bits < 2^31, lanes < 2^32; invalid lanes' entries
    are SENT and sort last).  JAX marks an entry set in the batch when
    its bit's segment starts at an earlier lane (a cummax of segment
    starts and a gather of the first lane) or when it repeats the
    previous entry's (bit, lane), the reference's `cnt += !!(*q & u);
    *q |= u;` for a key that probes one bit twice.  Within a segment the
    lanes never fall, so the two rules together mark exactly the entries
    that are not the first of their bit's segment, which is what is
    computed here (as pipeline/yak_admit.py `_fp_sort` does).  The
    verdicts return to probe order through the sort's permutation (a
    scatter, where JAX sorts on the position)."""
    idxs = probe_indices(keys, spec)
    n_lanes = keys.shape[0]
    assert n_lanes < 1 << 32, "insert_sequential: lanes must fit 32 bits"
    lane = torch.arange(n_lanes, device=keys.device)
    flat = torch.cat([torch.where(valid, (ix << 32) | lane, SENT)
                      for ix in idxs])
    s, order = torch.sort(flat, stable=True)
    s_bit = s >> 32
    by_probe = torch.zeros_like(s, dtype=torch.bool)
    by_probe[order[1:]] = s_bit[1:] == s_bit[:-1]
    by_probe = by_probe.view(spec.n_hashes, n_lanes)
    preset = valid.clone()
    for h, ix in enumerate(idxs):
        preset &= (bits[torch.where(valid, ix, 0)] == 1) | by_probe[h]
    _set(bits, idxs, valid)
    return bits, preset


def test(bits: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
         spec: BloomSpec) -> torch.Tensor:
    """Pure membership test (all bits set), no mutation (bloom.py:178)."""
    return _all_set(bits, probe_indices(keys, spec), valid)
