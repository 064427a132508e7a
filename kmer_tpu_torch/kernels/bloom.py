"""Blocked bloom filter: geometry, probe indices and the bits array
(port of kmer_tpu/kernels/bloom.py).

The probe math of the reference's yak_bf_insert: 512-bit blocks
(BLK_SHIFT 9), one bloom per prefix subtable (2^pre subtables of
2^(n_shift - pre) bits each, laid out one after another), a block picked
by the key's middle bits, and n_hashes double-hashing probes inside the
block (z += h2, with the (h2 & 31) == 0 adjustment).

Storage is packed: 2^(n_shift - owner_bits - 3) bytes (`make_bits`), bit
b at byte b >> 3, bit b & 7 (16 GiB at -b37), where the JAX package
keeps one uint8 byte a bit and so stops at 2^31 bits.  `unpack_bits` and
`pack_bits` convert between the two layouts (the table engine's
checkpoint, tests against JAX).  Single-file yak-count needs only the
probe indices (the deferred admission, pipeline/yak_admit.py, resolves
the bloom's verdicts by sorting probe entries); two-file yak-count gates
pass 1 with `insert` or, by default, `insert_sequential`, the
reference's lane-by-lane test-and-set, and SortYakEngine with `admit`,
which returns the admitted keys themselves.

For CUDA tensors the test-and-set is csrc/bloom.cu (`ktt_bloom_insert`:
each bit newly set in a call records its first setter in a hash table
that the call zeroes first, and each probe compares its rank with it;
no torch operation runs on the card inside a call).  The plain versions (`*_plain`) give the same
verdicts and bits in PyTorch, by one stable sort of the probe entries
by bit, and run for CPU tensors and under plain_kernels.

Keys arrive biased (kernels/keys.py), so `probe_indices` un-biases them
first.  A key may then have its top bit set (k = 32), and `>>` on int64
is arithmetic, so every right shift is masked to the bits a logical
shift would keep.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
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


def n_bytes(spec: BloomSpec) -> int:
    """Bytes of a shard's packed bits array: 2^(n_shift - owner_bits - 3)."""
    return 1 << (spec.n_shift - spec.owner_bits - 3)


def make_bits(spec: BloomSpec, device=None) -> torch.Tensor:
    """The zeroed packed bits array, uint8, n_bytes(spec) long."""
    assert BLK_SHIFT <= spec.n_shift - spec.pre, (
        "bloom smaller than one block per subtable")
    assert spec.owner_bits <= spec.pre
    return torch.zeros(n_bytes(spec), dtype=torch.uint8, device=device)


_SHIFTS = torch.arange(8, dtype=torch.uint8)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Packed bits -> the JAX package's layout, one uint8 (0 or 1) a
    bit."""
    sh = _SHIFTS.to(bits.device)
    return ((bits[:, None] >> sh) & 1).reshape(-1)


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """One byte a bit (0 or 1; a multiple of 8 of them) -> packed bits."""
    sh = _SHIFTS.to(flags.device)
    return ((flags.view(-1, 8) & 1) << sh).sum(1, dtype=torch.uint8)


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


def _get(bits: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """The bits at indices ix (int64), as uint8 0 or 1."""
    return (bits[ix >> 3] >> (ix & 7).to(torch.uint8)) & 1


def _all_set(bits: torch.Tensor, idxs, valid: torch.Tensor) -> torch.Tensor:
    """Per lane: every probe bit is set in `bits` (invalid lanes read
    bit 0 and come out False)."""
    ok = valid.clone()
    for ix in idxs:
        ok &= _get(bits, torch.where(valid, ix, 0)) == 1
    return ok


def _insert_plain(bits: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor, spec: BloomSpec, sequential: bool
                  ) -> torch.Tensor:
    """The plain test-and-set: preset, bits updated in place.

    The probes are laid out lane-major, (lane, probe) order, so one
    stable sort by bit of the probes of bits unset before the call puts
    each bit's first setter first; every later probe of that bit counts
    as set under the sequential semantics (an earlier lane, or an
    earlier probe of its own lane, the reference's `cnt += !!(*q & u);
    *q |= u;`).  A bit index may have any width: no (bit, lane) pair is
    packed into one int64.  The new bits are set by an accumulating
    index_put of their distinct masks: within a byte they are distinct
    powers of two of unset bits, so the sum is the OR."""
    ent = torch.stack(probe_indices(keys, spec), 1)  # (lanes, n_hashes)
    v = valid[:, None].expand_as(ent)
    was = (_get(bits, torch.where(v, ent, 0)) == 1) & v
    fresh = v & ~was
    got = was
    if sequential:
        flat = torch.where(fresh, ent, SENT).reshape(-1)
        s, order = torch.sort(flat, stable=True)
        later = torch.zeros_like(flat, dtype=torch.bool)
        later[order[1:]] = (s[1:] == s[:-1]) & (s[1:] != SENT)
        got = was | later.view_as(ent)
    preset = valid & got.all(1)
    new = torch.unique(ent[fresh])
    bits.index_put_((new >> 3,), (1 << (new & 7)).to(torch.uint8),
                    accumulate=True)
    return preset


def _insert_kernel(bits: torch.Tensor, keys: torch.Tensor,
                   valid: Optional[torch.Tensor], spec: BloomSpec,
                   sequential: bool, want_keys: bool):
    """csrc/bloom.cu on the card: (preset, or the admitted keys with
    want_keys), bits updated in place.  `valid` None: the lanes whose key
    is not the sentinel."""
    n = keys.shape[0]
    if (keys.dtype != torch.int64 or keys.dim() != 1
            or bits.dtype != torch.uint8 or bits.device != keys.device
            or not bits.is_contiguous() or bits.data_ptr() % 4
            or bits.shape[0] != n_bytes(spec)
            or (valid is not None and (valid.dtype != torch.bool
                                       or valid.shape != keys.shape))):
        raise ValueError("bloom: need int64 keys, bool valid and the "
                         "spec's contiguous uint8 bits on one device")
    if n * spec.n_hashes >= 1 << 32:
        raise ValueError("bloom: lanes * n_hashes must be below 2^32")
    keys = keys.contiguous()
    valid = valid.contiguous() if valid is not None else None
    out = torch.empty(n, dtype=torch.int64 if want_keys else torch.bool,
                      device=keys.device)
    if n == 0:
        return out
    # the first-setter table (the kernels zero it), at most two thirds full
    size = 1 << max(10, (3 * n * spec.n_hashes // 2).bit_length())
    tags = torch.empty(size, dtype=torch.int64, device=keys.device)
    ranks = torch.empty(size, dtype=torch.int32, device=keys.device)
    _build.launch(
        "ktt_bloom_insert", "bloom", keys, keys.data_ptr(),
        valid.data_ptr() if valid is not None else None, n, spec.pre,
        spec.n_shift, spec.n_hashes, spec.owner_bits, int(sequential),
        bits.data_ptr(), tags.data_ptr(), ranks.data_ptr(), size - 1,
        None if want_keys else out.data_ptr(),
        out.data_ptr() if want_keys else None)
    return out


def insert_plain(bits: torch.Tensor, keys: torch.Tensor,
                 valid: torch.Tensor, spec: BloomSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`insert` in plain PyTorch, on any device."""
    return bits, _insert_plain(bits, keys, valid, spec, False)


def insert_sequential_plain(bits: torch.Tensor, keys: torch.Tensor,
                            valid: torch.Tensor, spec: BloomSpec
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`insert_sequential` in plain PyTorch, on any device."""
    return bits, _insert_plain(bits, keys, valid, spec, True)


def insert(bits: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
           spec: BloomSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Test-and-set all probes (bloom.py:100-115).  Returns (bits,
    preset): preset[i] is True iff all n_hashes bits of lane i were set
    before this call (the `yak_bf_insert(...) == n_hash` gate).  `bits`
    is updated in place and returned.  The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not keys.is_cuda:
        return insert_plain(bits, keys, valid, spec)
    return bits, _insert_kernel(bits, keys, valid, spec, False, False)


def insert_sequential(bits: torch.Tensor, keys: torch.Tensor,
                      valid: torch.Tensor, spec: BloomSpec
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """insert() with the reference's sequential test-and-set
    (bloom.py:118-175): preset[i] is True iff every probe bit of lane i
    was set before the call OR by a strictly earlier lane of it, or, for
    a key that probes one bit twice, by its own earlier probe.  The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not keys.is_cuda:
        return insert_sequential_plain(bits, keys, valid, spec)
    return bits, _insert_kernel(bits, keys, valid, spec, True, False)


def admit(bits: torch.Tensor, keys: torch.Tensor, spec: BloomSpec,
          sequential: bool = True, plain: bool = False) -> torch.Tensor:
    """Pass 1's gate on a block of sentinelized keys: the keys that
    `insert_sequential` (or, not sequential, `insert`) admits, the
    sentinel elsewhere; bits updated in place.  On the card one kernel
    call computes the valid lanes, the verdicts and the admitted keys;
    `plain` (or CPU tensors) takes the plain version."""
    if plain or not keys.is_cuda:
        valid = keys != SENT
        preset = _insert_plain(bits, keys, valid, spec, sequential)
        return torch.where(valid & preset, keys, SENT)
    return _insert_kernel(bits, keys, None, spec, sequential, True)


def test(bits: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
         spec: BloomSpec) -> torch.Tensor:
    """Pure membership test (all bits set), no mutation (bloom.py:178)."""
    return _all_set(bits, probe_indices(keys, spec), valid)
