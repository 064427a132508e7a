"""The open-addressing k-mer count table (port of
kmer_tpu/table/count_table.py).

A table of cap slots (a power of two) holds three planes: `state` (uint8
EMPTY / FULL / DELETED), `key` (one biased int64 key a slot, as
everywhere in the port, kernels/keys.py; an EMPTY slot holds the biased
0, so its (hi, lo) halves are JAX's zeros) and `cnt` (uint32 counts in
int32 lanes), and `n_full`, the FULL slots (int64, 0-dim, on the
device).  A batch resolves every valid lane's key to its slot in
synchronous rounds (kernels/table.py `resolve_slots`, csrc/table.cu on
the card), then adds per-slot deltas with one scatter-add, so duplicates
combine exactly; saturation is a min after the add (kc-c4.c:126's gate
on sequential increments).  Deletion only marks DELETED, so probe
chains stay intact; `rebuild` rehashes into a fresh table (resize, and
yak_ch_shrink with min_count = 2).

The layout equals the JAX package's slot for slot (the slot mix, the
round arbitration and the lane order are the same), so `to_jax_planes`
gives JAX's (state, key_hi, key_lo, cnt) arrays and a checkpoint crosses
between the packages.

Unlike the JAX package's pure functions, these update the table's
planes in place (state and key in the resolve, cnt and state after it)
and return the table: the engines keep one table and drop the old one,
so no plane is copied.  `plain_kernels=True` makes the resolve take its
plain PyTorch version on any device; the count delta (`index_add_` on
int64, then & 0xFFFFFFFF, then the min), `insert_gated`'s first lane a
slot (`scatter_reduce` amin) and `hist` (one `bincount`) are plain
PyTorch everywhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import table as kt
from ..kernels.keys import BIAS_I64, from_hi_lo, to_hi_lo
from ..kernels.table import DELETED, EMPTY, FULL  # noqa: F401

_U32 = 0xFFFFFFFF


class CountTable(NamedTuple):
    state: torch.Tensor   # (cap,) uint8: EMPTY / FULL / DELETED
    key: torch.Tensor     # (cap,) int64, biased
    cnt: torch.Tensor     # (cap,) int32 holding uint32 counts
    n_full: torch.Tensor  # () int64, the FULL slots

    @property
    def capacity(self) -> int:
        return self.state.shape[0]


def make(capacity: int, device=None) -> CountTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return CountTable(
        state=torch.zeros(capacity, dtype=torch.uint8, device=device),
        key=torch.full((capacity,), BIAS_I64, dtype=torch.int64,
                       device=device),
        cnt=torch.zeros(capacity, dtype=torch.int32, device=device),
        n_full=torch.zeros((), dtype=torch.int64, device=device),
    )


class ResolveResult(NamedTuple):
    table: CountTable
    slot: torch.Tensor     # (m,) int64; == capacity when absent / invalid
    found: torch.Tensor    # (m,) bool; the key existed before this batch
    created: torch.Tensor  # (cap,) bool; the slot was claimed by this batch


def resolve_slots(table: CountTable, keys: torch.Tensor, valid: torch.Tensor,
                  create_new: bool, plain_kernels: bool = False
                  ) -> ResolveResult:
    """Every valid lane's slot, claiming new slots with create_new
    (count_table.py:74-159); without it an absent key resolves to
    slot == capacity (a drop index for the scatters below)."""
    fn = kt.resolve_slots_plain if plain_kernels else kt.resolve_slots
    r = fn(table.state, table.key, keys, valid, create_new)
    return ResolveResult(table, r.slot, r.found, r.created)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 lanes holding uint32 -> their int64 values."""
    return x.to(torch.int64) & _U32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 lanes with the same bits."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def _slot_delta(cap: int, slot: torch.Tensor, weights: torch.Tensor
                ) -> torch.Tensor:
    """Per-slot sum of the lanes' weights (int64, uint32 values; lanes at
    slot == cap are dropped), count_table.py:162-165."""
    d = torch.zeros(cap + 1, dtype=torch.int64, device=slot.device)
    d.index_add_(0, slot, weights.to(torch.int64))
    return d[:cap] & _U32


def _add_counts(table: CountTable, delta: torch.Tensor,
                max_count: Optional[int]) -> torch.Tensor:
    """cnt + delta, wrapping as uint32, then saturated at max_count."""
    cnt = (_u32(table.cnt) + delta) & _U32
    if max_count is not None:
        cnt = torch.clamp(cnt, max=max_count)
    return _i32(cnt)


def insert(table: CountTable, keys: torch.Tensor, valid: torch.Tensor,
           max_count: Optional[int], weights: Optional[torch.Tensor] = None,
           plain_kernels: bool = False) -> Tuple[CountTable, torch.Tensor]:
    """Insert a batch (count_table.py:168-188): the gated increments of
    kc-c2.c:65-72 / kc-c4.c:116-128 over every valid lane, each lane
    adding its weight (uint32 bits in int32 or int64 lanes; 1 without
    weights).  Returns (table, n_new) with n_new an int64 0-dim tensor."""
    res = resolve_slots(table, keys, valid, True, plain_kernels)
    w = (_u32(weights) if weights is not None
         else torch.ones_like(valid, dtype=torch.int64))
    w = torch.where(valid, w, 0)
    delta = _slot_delta(table.capacity, res.slot, w)
    n_new = res.created.sum()
    t = table._replace(cnt=_add_counts(table, delta, max_count),
                       n_full=table.n_full + n_new)
    return t, n_new


def insert_gated(table: CountTable, keys: torch.Tensor, valid: torch.Tensor,
                 preset: torch.Tensor, max_count: Optional[int],
                 plain_kernels: bool = False):
    """The bloom-gated insert of yak_ch_insert_list
    (count_table.py:191-242, yak-count.c:156-169): of a key's c lanes in
    the batch, the first one in lane order adds 1 only when its bloom
    bits were all set before it (`preset`, from bloom.insert or
    insert_sequential), the others 1 each; a slot this batch claimed
    whose key ends with no increment rolls back to DELETED (probe chains
    through it stay valid).  Returns (table, n_new, n_dead), 0-dim int64
    tensors; DELETED slots are probe-opaque and not in n_full, so the
    caller counts n_dead and rebuilds before they clog the chains."""
    res = resolve_slots(table, keys, valid, True, plain_kernels)
    cap, m = table.capacity, keys.shape[0]
    lane = torch.arange(m, device=keys.device)
    first = torch.full((cap + 1,), m, dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, res.slot, lane, "amin")
    is_first = first[res.slot] == lane
    contrib = valid & (preset | ~is_first)
    delta = _slot_delta(cap, res.slot, contrib)
    dead = res.created & (delta == 0)
    table.state[dead] = DELETED
    n_dead = dead.sum()
    n_new = res.created.sum() - n_dead
    t = table._replace(cnt=_add_counts(table, delta, max_count),
                       n_full=table.n_full + n_new)
    return t, n_new, n_dead


def add_existing(table: CountTable, keys: torch.Tensor, valid: torch.Tensor,
                 max_count: Optional[int],
                 weights: Optional[torch.Tensor] = None,
                 plain_kernels: bool = False) -> CountTable:
    """Increment the counts of keys already present, create nothing (yak
    pass 2: count_table.py:245-260, yak-count.c:170-174)."""
    res = resolve_slots(table, keys, valid, False, plain_kernels)
    w = (_u32(weights) if weights is not None
         else torch.ones_like(valid, dtype=torch.int64))
    w = torch.where(valid & res.found, w, 0)
    delta = _slot_delta(table.capacity, res.slot, w)
    return table._replace(cnt=_add_counts(table, delta, max_count))


def get(table: CountTable, keys: torch.Tensor, valid: torch.Tensor,
        plain_kernels: bool = False) -> torch.Tensor:
    """Each lane's count (int32, as JAX's astype), or -1 when absent or
    invalid (yak_ch_get; count_table.py:263-268)."""
    res = resolve_slots(table, keys, valid, False, plain_kernels)
    c = table.cnt[torch.where(res.found, res.slot, 0)]
    return torch.where(valid & res.found, c, -1)


def hist(table: CountTable, n_bins: int) -> torch.Tensor:
    """The count histogram over FULL slots, bin min(cnt, n_bins - 1), as
    int64 (count_table.py:271-283; bin 0 exists, the callers print
    1..n_bins - 1)."""
    b = torch.clamp(_u32(table.cnt[table.state == FULL]), max=n_bins - 1)
    return torch.bincount(b, minlength=n_bins)


def clear_counts(table: CountTable) -> CountTable:
    """Zero the counts, keep the keys (yak_ch_clear)."""
    return table._replace(cnt=torch.zeros_like(table.cnt))


def occupancy(table: CountTable) -> torch.Tensor:
    return (table.state == FULL).sum()


def rebuild(table: CountTable, new_capacity: int, min_count: int = 0,
            max_count: Optional[int] = None, plain_kernels: bool = False
            ) -> CountTable:
    """A fresh table of new_capacity holding the FULL keys with cnt in
    [min_count, max_count] (count_table.py:290-309): yak_ch_shrink with
    min_count = 2, a resize (khashl's rehash) with min_count = 0.  The
    keys are inserted in slot order, each weighted by its count; the
    tombstones are swept."""
    hi_max = max_count if max_count is not None else _U32
    c = _u32(table.cnt)
    keep = (table.state == FULL) & (c >= min_count) & (c <= hi_max)
    fresh = make(new_capacity, table.state.device)
    t, _ = insert(fresh, table.key, keep, None, table.cnt, plain_kernels)
    return t


def to_jax_planes(table: CountTable):
    """(state, key_hi, key_lo, cnt) as the JAX package's numpy planes:
    uint8, uint32, uint32, uint32."""
    hi, lo = to_hi_lo(table.key)
    return (table.state.cpu().numpy(), hi, lo,
            table.cnt.cpu().numpy().view(np.uint32))


def from_jax_planes(state, key_hi, key_lo, cnt, n_full: int,
                    device=None) -> CountTable:
    """The inverse of `to_jax_planes`."""
    return CountTable(
        torch.from_numpy(np.asarray(state, np.uint8)).to(device),
        from_hi_lo(key_hi, key_lo, device),
        torch.from_numpy(np.ascontiguousarray(cnt, np.uint32).view(
            np.int32)).to(device),
        torch.tensor(int(n_full), dtype=torch.int64, device=device))
