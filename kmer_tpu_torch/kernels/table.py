"""Slot resolution of the open-addressing count table (the round loop of
kmer_tpu/table/count_table.py:74-159 `resolve_slots`; table/count_table.py
builds the table's operations on it).

Every valid lane maps its biased int64 key to a slot of the table's
planes (`state` uint8 EMPTY / FULL / DELETED, `tkey` int64): in rounds,
each active lane reads slot (slot_mix32(key) + off) & (cap - 1); its own
key there resolves it; an EMPTY slot, with create_new, is claimed by a
scatter-max of tag = round * m + lane + 1 (uint32, wrapping; m = the
lane plane's length) and won by the highest tag, whose key and FULL are
written, the losers reading the slot again next round; without
create_new an EMPTY slot means absent; any other slot (FULL with another
key, or DELETED) advances the lane by one.  The arbitration is
deterministic: both forms here give the JAX package's planes and
outputs exactly.

  resolve_slots_plain   the loop in plain PyTorch, over the compacted
                        list of active lanes (a round's result does not
                        depend on the order of its lanes)
  resolve_slots_kernel  csrc/table.cu: every round in one cooperative
                        launch (the grid while many lanes are active, one
                        block for the tail), one host read a call; a
                        refused launch raises (no fallback)
  resolve_slots         the kernel for CUDA tensors, the plain version
                        for CPU tensors
  kernel_shape          the kernel's cooperative grid on a card

In place: the winners' keys and FULL are written into `state` and `tkey`
(the JAX package returns new planes).  Each returns Resolved(slot int64
[m], cap where absent or invalid; found bool [m], the key was in the
table before the call; created bool [cap], the slot was claimed by this
call; rounds; probes, the lanes probed over all rounds).  A loop that
cannot end (a batch with more distinct keys than free slots, which the
JAX package's loop spins on) raises after 2 * cap + 2 rounds: a lane
that can resolve does so within cap advances and at most one lost claim
at each slot it visits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .hash64 import slot_mix32

EMPTY, FULL, DELETED = 0, 1, 2


class Resolved(NamedTuple):
    slot: torch.Tensor
    found: torch.Tensor
    created: torch.Tensor
    rounds: int
    probes: int


def _check(state, tkey, keys, valid) -> None:
    cap = state.shape[0]
    if (state.dtype != torch.uint8 or tkey.dtype != torch.int64
            or keys.dtype != torch.int64 or valid.dtype != torch.bool):
        raise ValueError("resolve_slots: need uint8 state, int64 table keys, "
                         "int64 keys and a bool valid plane")
    if (state.dim() != 1 or tkey.shape != state.shape or keys.dim() != 1
            or valid.shape != keys.shape):
        raise ValueError("resolve_slots: need 1-D planes, table planes of "
                         "one length, keys and valid of one length")
    if cap < 1 or cap & (cap - 1) or cap > 1 << 31:
        raise ValueError("resolve_slots: the capacity must be a power of "
                         "two <= 2^31")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("resolve_slots: at most 2^31 - 1 lanes")
    if len({t.device for t in (state, tkey, keys, valid)}) != 1:
        raise ValueError("resolve_slots: the planes lie on different devices")


def _round_limit(cap: int) -> int:
    return 2 * cap + 2


def _spin(cap: int) -> RuntimeError:
    return RuntimeError(
        f"resolve_slots: lanes still active after {_round_limit(cap)} "
        f"rounds: the batch holds more distinct keys than the table of "
        f"{cap} slots has free (size it first, as the engines' _maybe_grow "
        f"does)")


def resolve_slots_plain(state: torch.Tensor, tkey: torch.Tensor,
                        keys: torch.Tensor, valid: torch.Tensor,
                        create_new: bool) -> Resolved:
    _check(state, tkey, keys, valid)
    cap, m, dev = state.shape[0], keys.shape[0], keys.device
    base = slot_mix32(keys) & (cap - 1)
    off = torch.zeros(m, dtype=torch.int64, device=dev)
    slot = torch.full((m,), cap, dtype=torch.int64, device=dev)
    found = torch.zeros(m, dtype=torch.bool, device=dev)
    created = torch.zeros(cap, dtype=torch.bool, device=dev)
    ticket = (torch.zeros(cap, dtype=torch.int64, device=dev)
              if create_new else None)
    lanes = torch.nonzero(valid).flatten()
    rnd = probes = 0
    while lanes.shape[0]:
        if rnd >= _round_limit(cap):
            raise _spin(cap)
        probes += lanes.shape[0]
        idx = (base[lanes] + off[lanes]) & (cap - 1)
        kk = keys[lanes]
        st = state[idx]
        is_empty = st == EMPTY
        is_match = (st == FULL) & (tkey[idx] == kk)
        won = torch.zeros_like(is_empty)
        if create_new:
            tag = (rnd * m + lanes + 1) & 0xFFFFFFFF
            ti, tt = idx[is_empty], tag[is_empty]
            ticket.scatter_reduce_(0, ti, tt, "amax")
            won[is_empty] = ticket[ti] == tt
            wi = idx[won]
            tkey[wi] = kk[won]
            state[wi] = FULL
            created[wi] = True
            done = is_match | won
        else:
            done = is_match | is_empty
        hit = is_match | won
        slot[lanes[hit]] = idx[hit]
        found[lanes[is_match]] = True
        adv = ~is_empty & ~is_match
        off[lanes[adv]] += 1
        lanes = lanes[~done]
        rnd += 1
    return Resolved(slot, found, created, rnd, probes)


def resolve_slots_kernel(state: torch.Tensor, tkey: torch.Tensor,
                         keys: torch.Tensor, valid: torch.Tensor,
                         create_new: bool) -> Resolved:
    _check(state, tkey, keys, valid)
    if not keys.is_cuda:
        raise ValueError("resolve_slots: the kernel takes CUDA tensors "
                         "(resolve_slots takes CPU tensors too)")
    if not all(t.is_contiguous() for t in (state, tkey, keys, valid)):
        raise ValueError("resolve_slots: need contiguous planes")
    cap, m, dev = state.shape[0], keys.shape[0], keys.device
    slot = torch.empty(m, dtype=torch.int64, device=dev)
    found = torch.empty(m, dtype=torch.bool, device=dev)
    created = torch.zeros(cap, dtype=torch.bool, device=dev)
    ticket = torch.zeros(cap if create_new else 1, dtype=torch.int32,
                         device=dev)
    # two lists of active lanes, 16 bytes an entry (key, lane, offset)
    lists = torch.empty(4 * m, dtype=torch.int64, device=dev)
    pos_case = torch.empty(m, dtype=torch.uint8, device=dev)
    # survivor counts, valid lanes, then rounds, probes, the limit's flag
    ctl = torch.zeros(6, dtype=torch.int64, device=dev)
    _build.launch(
        "ktt_resolve", "resolve", keys, keys.data_ptr(), valid.data_ptr(),
        m, cap, _round_limit(cap), state.data_ptr(), tkey.data_ptr(),
        ticket.data_ptr(), lists.data_ptr(), pos_case.data_ptr(),
        slot.data_ptr(), found.data_ptr(), created.data_ptr(),
        ctl.data_ptr(), int(create_new))
    rounds, probes, over = ctl[3:].tolist()  # the call's one host read
    if over:
        raise _spin(cap)
    return Resolved(slot, found, created, rounds, probes)


def kernel_shape(device: torch.device) -> dict:
    """The resolve kernel's cooperative grid on a card: blocks a SM, SMs,
    the grid's most blocks, registers a thread, the lanes of the
    one-block tail and threads a block."""
    out = torch.zeros(6, dtype=torch.int64)
    with torch.cuda.device(device):
        _build.check(_build.library().ktt_resolve_info(out.data_ptr()),
                     "resolve")
    return dict(zip(("blocks_per_sm", "sms", "blocks", "registers",
                     "tail_lanes", "threads"), out.tolist()))


def resolve_slots(state: torch.Tensor, tkey: torch.Tensor,
                  keys: torch.Tensor, valid: torch.Tensor,
                  create_new: bool) -> Resolved:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if keys.is_cuda:
        return resolve_slots_kernel(state, tkey, keys, valid, create_new)
    return resolve_slots_plain(state, tkey, keys, valid, create_new)
