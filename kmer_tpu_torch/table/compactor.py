"""Sort-based k-mer count engine ("compactor") (port of
kmer_tpu/table/compactor.py `KmerCompactor`).

Keys are biased int64 (kernels/keys.py): one plane carries what the JAX
package keeps as (hi, lo).  Counts are int32 holding the JAX package's
uint32 counts.

Accumulation is stream-sorted on every device, as in the JAX package's
stream-sorted engine; the port has no other.

One-plane mode (`key_bits <= 30`, i.e. k <= 15): as in the JAX package,
the stream ladder then holds one 32-bit key plane, sorts and merges it
(kernels/merge.py `merge_runs` on int32 runs) and counts 4 bytes a raw
lane against the budget.  Keys narrow to int32 once,
where they enter the ladder, and widen back to biased int64 where the
ladder folds into `_compact` / `_hist_sorted` (as the JAX package derives
its hi plane there, compactor.py:165-171), so the segment histogram
stays the int64 kernel.

  add_raw      append sentinelized key planes: 2^24-lane chunks are
               sorted as they arrive and carry-merged up a binary ladder
               (table/stream_ladder.py) with the merge-path kernels
               (kernels/merge.py `merge_runs`, out of place): int64
               runs, or int32 runs in one-plane mode.
  add_counted  append a (key, count) run in any order (a resumed
               checkpoint, a mesh shard's counts).
  compact      fold everything into the standing plane, one strictly
               ascending (key, count) run (`fold`): `add_counted`'s runs
               compact with one sort, the ladder run by ladder run
               (`_stream_runs`), and those runs and the standing plane
               merge by merge path (kernels/merge.py `merge_runs3`, the
               count a payload) into one segment reduce.  The budget
               counts the raw bytes added since the last fold, so a trip
               fires once a budget of new lanes.
  hist         histogram of per-key counts through the one-pass
               segment-histogram kernel (kernels/seghist.py
               `segment_hist_sorted`).
  counts_for   total multiplicity of each query key: two
               `torch.searchsorted` calls on the sorted key plane (the
               JAX package's fixed-trip binary search, plain XLA there
               and plain torch here), weighted by a modular uint32
               cumsum when the runs carry counts.

`plain_kernels=True` makes the engine call the kernels' plain PyTorch
versions on any device, so the same engine can be held against itself
on the card; by default every kernel wrapper picks by the tensor's
device (CUDA kernel on the card, plain version on the CPU).

KMER_TPU_DEBUG (any non-empty value, read on every call) cross-checks
`hist` and `counts_for` as the JAX package does (compactor.py:595-607,
:635-652): each answer is computed a second time, from the same sorted
plane, by a plain-torch derivation that shares no kernel with the
normal path (`_hist_general`: a fresh sort and `bincount`;
`_counts_for_sortjoin` / `_counts_for_join`: a sort of data and query
lanes together), and any difference raises AssertionError.  The
answer returned is always the normal path's.  `DEBUG_CHECKS` counts
the cross-checks made.

Spans (utils/trace.py): `compactor.compact` (it ends in the
compaction's own synchronization, the segment ends' `nonzero`),
`compactor.fold` (a fold into a standing plane: `standing_lanes`,
`new_lanes`), `compactor.sort` and `compactor.merge` (`lanes_sorted`:
each sort's lanes, each merge's output lanes) and `compactor.throttle`
(a stream-throttle wait).
"""

from __future__ import annotations

import os
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels import merge, seghist
from ..kernels.keys import SENT, SENT32, from_hi_lo, narrow, to_u64, widen
from ..kernels.segops import segment_starts
from ..utils import trace

# raw keys fold into sorted runs of this many lanes as they arrive, and
# finalization pays only the ladder merges
_STREAM_CHUNK = 1 << 24
_STREAM_MIN = 1 << 16
# pushed chunks the host may run ahead of the device, unless
# KMER_TPU_THROTTLE_WINDOW says otherwise
_THROTTLE_WINDOW = 4
# KMER_TPU_DEBUG cross-checks made in this process, by method
DEBUG_CHECKS = {"hist": 0, "counts_for": 0}

Run = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (keys, counts or None)


def throttle_window() -> int:
    """KMER_TPU_THROTTLE_WINDOW, at least 1; _THROTTLE_WINDOW when unset
    or not an integer (compactor.py:379-391)."""
    try:
        return max(1, int(os.environ.get("KMER_TPU_THROTTLE_WINDOW", "")))
    except ValueError:
        return _THROTTLE_WINDOW


def debug_enabled() -> bool:
    """KMER_TPU_DEBUG is set to a non-empty value (compactor.py:595)."""
    return bool(os.environ.get("KMER_TPU_DEBUG"))


def _concat_runs(runs: List[Run]) -> Run:
    """Concatenate (keys, counts) runs."""
    return torch.cat([r[0] for r in runs]), torch.cat([r[1] for r in runs])


def _sort(keys: torch.Tensor, counts: Optional[torch.Tensor]) -> Run:
    with trace.span("compactor.sort", lanes_sorted=int(keys.shape[0])):
        if counts is None:
            return torch.sort(keys).values, None
        keys, order = torch.sort(keys)
        return keys, counts[order]


def _compact(keys: torch.Tensor, counts: Optional[torch.Tensor],
             pre_sorted: bool = False) -> Run:
    """(distinct keys, their int32 counts) of a run (_compact_impl,
    compactor.py:656-703): the run sorted (unless `pre_sorted` and
    unweighted), then `_reduce`."""
    if counts is not None or not pre_sorted:
        keys, counts = _sort(keys, counts)
    lanes = [(keys, None if counts is None else _wide(counts))]
    del keys, counts
    return _reduce(lanes)


def _wide(counts: torch.Tensor) -> torch.Tensor:
    """int32 counts as int64 in [0, 2^32), the uint32 values they hold."""
    return counts.to(torch.int64).bitwise_and_(0xFFFFFFFF)


def _reduce(lanes: List[Run]) -> Run:
    """(distinct keys, int32 counts) of the one sorted (keys, counts)
    pair in `lanes`, taken out of the list so that each plane frees once
    read; counts are None (a lane counts 1) or int64 in [0, 2^32), summed
    in place.  A key's count is the difference of the running sum at its
    segment's end and the previous one's, kept to its low 32 bits (the
    JAX package's modular uint32 arithmetic)."""
    keys, wide = lanes.pop()
    is_end = torch.ones_like(keys, dtype=torch.bool)
    torch.ne(keys[1:], keys[:-1], out=is_end[:-1])
    # the sentinel sorts last, so dropping its segment leaves every
    # other segment's previous end in place
    is_end &= keys != SENT
    ends = torch.nonzero(is_end).squeeze(1)
    del is_end
    out = keys[ends]
    del keys
    csum = ends + 1 if wide is None else wide.cumsum_(0)[ends]
    del wide, ends
    seg = torch.empty_like(csum)
    seg[:1] = csum[:1]
    torch.sub(csum[1:], csum[:-1], out=seg[1:])
    del csum
    return out, seg.to(torch.int32)


def _lanes(run: Run) -> int:
    return int(run[0].shape[0])


def fold(runs: List[Run], merge3=merge.merge_runs3) -> Run:
    """One strictly ascending (key, int32 count) run of the strictly
    ascending (key, int32 count) runs in `runs`, which it empties so that
    each run frees once read.  The runs merge two at a time, smallest
    first, as (key, count) lanes (`merge3`: kernels/merge.py
    `merge_runs3` or its plain twin, the count the int64 payload: a run's
    keys are distinct, so its (key, count) order is its key order), and
    one segment reduce (`_reduce`) sums each key's counts.  A merge holds
    its inputs and its output, 16 B a lane each, so the peak is about
    32 B a lane; a concatenation, sort and gather of the same runs, held
    meanwhile, took twice the fold's on an H100 at 2^26 lanes
    (tests/test_torch_cuda.py measures both)."""
    runs.sort(key=_lanes, reverse=True)
    if len(runs) == 1:
        return runs.pop()
    while len(runs) > 1:
        (ka, ca), (kb, cb) = runs.pop(), runs.pop()
        if ca.dtype == torch.int32:
            ca = _wide(ca)
        if cb.dtype == torch.int32:
            cb = _wide(cb)
        with trace.span("compactor.merge",
                        lanes_sorted=int(ka.shape[0] + kb.shape[0])):
            runs.append(merge3(ka, ca, kb, cb))
        del ka, ca, kb, cb
        runs.sort(key=_lanes, reverse=True)
    return _reduce(runs)


# -- the KMER_TPU_DEBUG derivations (plain torch, any device) ------------

def _hist_general(keys: torch.Tensor, counts: Optional[torch.Tensor],
                  n_bins: int, max_count: Optional[int], min_keep: int):
    """(hist int64[n_bins], n_distinct) of any (keys, counts) plane, the
    counterpart of _hist_xla_core (compactor.py:237-292): a one-plane
    plane widened to biased int64, sorted from scratch, each key's total
    the uint32 ends-diff (`_compact`), the sentinel's segment dropped,
    totals below min_keep dropped, the rest clamped to max_count and
    n_bins - 1 and counted with bincount.  It never reaches the segment
    histogram (kernels/seghist.py), kernel or plain twin."""
    if keys.dtype == torch.int32:
        keys = widen(keys)
    total = _compact(keys, counts)[1].to(torch.int64) & 0xFFFFFFFF
    total = total[total >= min_keep]
    if max_count is not None:
        total = total.clamp(max=max_count)
    # every kept total is >= min_keep >= 1, so bin 0 stays 0, as JAX sets it
    hist = torch.bincount(total.clamp(max=n_bins - 1), minlength=n_bins)
    return hist, int(total.shape[0])


def _join_lanes(keys: torch.Tensor, q: torch.Tensor):
    """The sort-joins' shared start: the data lanes (sentinel lanes
    dropped: they hold no key, so the all-ones query counts 0 as on the
    binary search) followed by the distinct queries, sorted stably by
    key.  The concatenation lists data before queries and queries by
    index, so the stable sort orders the lanes by (key, tag) as the JAX
    package's two-key sort does.  Returns (data mask, order, sorted
    keys, distinct queries, inverse)."""
    data = keys != SENT
    uq, inverse = torch.unique(q, return_inverse=True)
    merged = torch.cat([keys[data], uq])
    s_key, order = torch.sort(merged, stable=True)
    return data, order, s_key, uq, inverse


def _counts_for_sortjoin(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unweighted counts of the biased int64 queries q (duplicates
    allowed) in the data lanes keys (any order), int64 in query order:
    the tag sort-join of _counts_for_sortjoin_impl (compactor.py:790-822).
    Tag 0 marks data, 1 + i the i-th distinct query; at a query lane
    every earlier lane of its segment is data, so its count is
    pos - segment start.  A lane's segment start is the start whose
    number the running count of starts gives: the positions JAX's cummax
    of start positions gives, without torch.cummax (on an H100, the
    check at 2^26 lanes took 204 ms with a cummax, 16 ms without)."""
    data, order, s_key, uq, inverse = _join_lanes(keys, q)
    n = int(data.sum())
    tag = torch.cat([torch.zeros(n, dtype=torch.int64, device=q.device),
                     torch.arange(1, uq.shape[0] + 1, device=q.device)])
    s_tag = tag[order]
    starts = segment_starts(s_key)
    at = torch.nonzero(s_tag > 0).squeeze(1)
    start = torch.nonzero(starts).squeeze(1)[torch.cumsum(starts, 0)[at] - 1]
    out = torch.empty_like(uq)
    out[s_tag[at] - 1] = at - start
    return out[inverse]


def _counts_for_join(keys: torch.Tensor, counts: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Weighted counts of the queries q in the (keys, int32 counts) lanes,
    int64 in query order: the origin / count / query-index sort-join of
    _counts_for_impl (compactor.py:824-862).  A query lane ends its
    segment, so its key's total is the running sum there minus the one
    at the previous segment's end, kept to its low 32 bits (the JAX
    package's modular uint32 arithmetic)."""
    data, order, s_key, uq, inverse = _join_lanes(keys, q)
    nq = uq.shape[0]
    c = torch.cat([counts[data].to(torch.int64) & 0xFFFFFFFF,
                   torch.zeros(nq, dtype=torch.int64, device=q.device)])
    qidx = torch.cat([torch.full((c.shape[0] - nq,), -1, device=q.device),
                      torch.arange(nq, device=q.device)])
    is_end = torch.ones_like(s_key, dtype=torch.bool)
    is_end[:-1] = segment_starts(s_key)[1:]
    ends = torch.nonzero(is_end).squeeze(1)
    e_csum = torch.cumsum(c[order], 0)[ends]
    seg = torch.diff(e_csum, prepend=e_csum.new_zeros(1)) & 0xFFFFFFFF
    e_q = qidx[order][ends]
    out = torch.empty_like(uq)
    out[e_q[e_q >= 0]] = seg[e_q >= 0]
    return out[inverse]


def _counts_for_bs(keys: torch.Tensor, counts: Optional[torch.Tensor],
                   q: torch.Tensor) -> torch.Tensor:
    """`counts_for`'s join on the sorted plane: each query's segment is
    [searchsorted left, searchsorted right); weighted runs sum their
    uint32 counts with the JAX package's modular arithmetic; the
    all-ones key counts 0 (the JAX package's `_key_succ` wraps there)."""
    lb = torch.searchsorted(keys, q)
    ub = torch.searchsorted(keys, q, right=True)
    if counts is None:
        out = ub - lb
    else:
        csum = torch.cumsum(counts.to(torch.int64) & 0xFFFFFFFF, 0)
        csum = torch.cat([csum.new_zeros(1), csum])
        out = (csum[ub] - csum[lb]) & 0xFFFFFFFF
    return torch.where(q == SENT, 0, out)


def _check_hist(plane: Run, hist: np.ndarray, n_distinct: int,
                bins_cfg) -> None:
    """KMER_TPU_DEBUG: hold hist's answer against `_hist_general` on the
    same plane; raise on any difference (compactor.py:595-607)."""
    DEBUG_CHECKS["hist"] += 1
    want, want_nd = _hist_general(*plane, *bins_cfg)
    want = want.cpu().numpy()
    if np.array_equal(hist, want) and n_distinct == want_nd:
        return
    bad = np.flatnonzero(hist != want)
    where = (f"bin {bad[0]} holds {hist[bad[0]]} against {want[bad[0]]} "
             f"({bad.size} bins differ)" if bad.size else "every bin agrees")
    raise AssertionError(
        f"KMER_TPU_DEBUG: Pallas/XLA histogram mismatch: {where}; "
        f"n_distinct {n_distinct} against {want_nd} (segment histogram "
        "against a fresh sort)")


def _check_counts_for(plane: Run, q: torch.Tensor, got: np.ndarray) -> None:
    """KMER_TPU_DEBUG: hold counts_for's answer against the sort-join on
    the same plane; raise on any difference (compactor.py:635-652)."""
    DEBUG_CHECKS["counts_for"] += 1
    keys, counts = plane
    want = (_counts_for_sortjoin(keys, q) if counts is None
            else _counts_for_join(keys, counts, q)).cpu().numpy()
    bad = np.flatnonzero(got != want)
    if not bad.size:
        return
    i = bad[0]
    key = int(to_u64(q[i:i + 1].cpu().numpy())[0])
    raise AssertionError(
        f"KMER_TPU_DEBUG: counts_for binary-search/sort-join mismatch: "
        f"query {i} (key {key:#018x}) counts {got[i]} against {want[i]} "
        f"({bad.size} of {got.size} queries differ)")


class KmerCompactor:
    """Accumulate-and-sort count engine (see module docstring)."""

    # Budget default 2 GiB of raw keys (8 bytes a lane), as in the JAX
    # package, but counted since the last fold: the standing plane's
    # bytes do not trip it (the JAX package counts them, 12 a key).
    def __init__(self, device, budget_bytes: int = 2 << 30,
                 key_bits: Optional[int] = None, plain_kernels: bool = False,
                 stream_chunk: Optional[int] = None,
                 stream_min: Optional[int] = None):
        self.device = torch.device(device)
        # the stream ladder's run quantum and smallest padded run (a mesh
        # shard takes smaller ones, as the JAX package's mesh does)
        self.stream_chunk = stream_chunk or _STREAM_CHUNK
        self.stream_min = stream_min or _STREAM_MIN
        # add_counted's runs, and at runs[0] the standing plane, the last
        # fold's strictly ascending run; no other run's order is known
        self.runs: List[Run] = []
        self._standing = False
        self.budget_bytes = budget_bytes
        self._bytes = 0  # raw bytes added since the last fold
        # keys < 2^30 (k <= 15 after hash64) fit one int32 plane whose
        # sentinel INT32_MAX no key can equal (compactor.py:311-313 takes
        # key_bits <= 31 for its u32 plane, whose sentinel is 2^32 - 1)
        self.one_plane = key_bits is not None and key_bits <= 30
        self._seg_hist = (seghist.segment_hist_sorted_plain if plain_kernels
                          else seghist.segment_hist_sorted)
        # both ladders' merge: int64 runs, or int32 runs in one-plane mode
        self._merge = (merge.merge_runs_plain if plain_kernels
                       else merge.merge_runs)
        # the fold's merge of (key, count) lanes
        self._merge3 = (merge.merge_runs3_plain if plain_kernels
                        else merge.merge_runs3)
        self._events: deque = deque()
        self._throttle_window = throttle_window()
        self.last_n_unique = 0  # distinct keys as of the last compact()
        self.stream = self._make_ladder()

    def add_raw(self, keys: torch.Tensor) -> None:
        """Append sentinelized keys (invalid lanes already SENT)."""
        if self.one_plane:
            self.stream.add((narrow(keys),))
            self._bytes += int(keys.shape[0]) * 4
        else:
            self.stream.add((keys,))
            self._bytes += int(keys.shape[0]) * 8
        if self._bytes > self.budget_bytes:
            self.compact()

    def add_counted(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        self.runs.append((keys, counts.to(torch.int32)))
        self._bytes += int(keys.shape[0]) * 12

    # -- the stream ladder ---------------------------------------------

    def _make_ladder(self):
        from .stream_ladder import StreamLadder

        return StreamLadder(
            chunk=self.stream_chunk,
            min_pad=self.stream_min,
            sort_fn=lambda p: _sort(p[0], None)[:1],
            merge_fn=self._merge_runs,
            pad_fn=self._pad_run,
            concat_fn=lambda runs: (torch.cat([r[0] for r in runs]),),
            slice_fn=lambda p, a, b: (p[0][a:b],),
            size_fn=lambda p: int(p[0].shape[0]),
            on_push=self._throttle_push,
        )

    def _throttle_push(self, planes) -> None:
        """Bound how far the host runs ahead of the device: record an
        event per pushed chunk and wait on the one a throttle window of
        chunks back, so at most that many chunks' buffers are in flight
        (the JAX package's readback throttle, compactor.py:369-411)."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events.append(ev)
        if len(self._events) > self._throttle_window:
            with trace.span("compactor.throttle"):
                self._events.popleft().synchronize()

    def _merge_runs(self, a, b):
        with trace.span("compactor.merge", lanes_sorted=int(
                a[0].shape[0] + b[0].shape[0])):
            return (self._merge(a[0], b[0]),)

    @staticmethod
    def _pad_run(planes, target: int):
        n = planes[0].shape[0]
        if target == n:
            return planes
        sent = SENT32 if planes[0].dtype == torch.int32 else SENT
        pad = planes[0].new_full((target - n,), sent)
        return (torch.cat([planes[0], pad]),)

    def _keys_of(self, planes) -> torch.Tensor:
        """A sorted ladder plane as biased int64 keys (one-plane widens)."""
        return widen(planes[0]) if self.one_plane else planes[0]

    def _stream_keys(self) -> torch.Tensor:
        return self._keys_of(self.stream.planes())

    def _stream_runs(self) -> List[Run]:
        """The ladder as strictly ascending (key, count) runs, the ladder
        cleared: its merged plane compacted while it holds at most two
        chunks; past that each ladder run, already sorted, compacts on its
        own and its raw plane frees, so the ladder never folds into one
        giant plane (compactor.py:488-521)."""
        lad = self.stream
        if lad.data_lanes <= self.stream_chunk * 2:
            keys = self._stream_keys()
            lad.clear()
            return [_compact(keys, None, pre_sorted=True)]
        runs = []
        if lad.pending:
            cat = (lad.pending[0] if len(lad.pending) == 1
                   else lad._concat(lad.pending))
            n = lad._size(cat)
            target = max(lad.min_pad, 1 << max(0, (n - 1).bit_length()))
            runs.append(lad._sort(lad._pad(cat, target)))
        runs.extend(lad.ladder.values())
        lad.clear()
        runs.sort(key=_lanes, reverse=True)
        out = []
        while runs:
            out.append(_compact(self._keys_of(runs.pop(0)), None,
                                pre_sorted=True))
        return out

    def compact(self) -> None:
        """Fold all runs into one (key, count) run (compactor.py:523-561):
        a `compactor.compact` span."""
        with trace.span("compactor.compact"):
            self._compact_all()

    def _compact_all(self) -> None:
        """Fold every run into the standing plane.  The new runs are
        the ladder's (`_stream_runs`) and one of `add_counted`'s (their
        order is not known), compacted with one sort.  They fold into
        the standing plane under a `compactor.fold` span, or make the
        first one."""
        standing = self.runs.pop(0) if self._standing else None
        loose, self.runs = self.runs, []
        new = self._stream_runs() if self.stream else []
        if loose:
            new.append(_compact(*_concat_runs(loose)))
            loose.clear()
        sp = trace.NULL
        if standing is not None:
            if new:
                sp = trace.span("compactor.fold",
                                standing_lanes=_lanes(standing),
                                new_lanes=sum(map(_lanes, new)))
            new.append(standing)
            del standing
        if new:
            with sp:
                self._store_compacted(fold(new, self._merge3))

    def _store_compacted(self, run: Run) -> None:
        self.runs = [run]
        self._standing = True
        self.last_n_unique = int(run[0].shape[0])
        self._bytes = 0

    def hist(self, n_bins: int, max_count: Optional[int], min_keep: int = 1):
        """(histogram int64[n_bins], n_distinct) over all keys."""
        plane = self._sorted_plane()
        if plane is None:
            return np.zeros(n_bins, np.int64), 0
        hist, n_distinct = self._hist_sorted(*plane, n_bins, max_count,
                                             min_keep)
        if debug_enabled():
            _check_hist(plane, hist, n_distinct, (n_bins, max_count,
                                                  min_keep))
        return hist, n_distinct

    def _sorted_plane(self) -> Optional[Run]:
        """The sorted (keys, counts or None) plane that ends a count, or
        None when the engine holds nothing: the ladder alone -> its
        merged plane; else the standing plane, after `compact` folds the
        rest into it."""
        if not self.runs:
            return (self._stream_keys(), None) if self.stream else None
        if self.stream or len(self.runs) > int(self._standing):
            self.compact()
        return self.runs[0]

    def _hist_sorted(self, keys, counts, n_bins, max_count, min_keep):
        """The _hist_impl_tpu shape (compactor.py:176-217) after the sort:
        the segment histogram of sorted keys, the open final run included."""
        if not keys.shape[0]:
            return np.zeros(n_bins, np.int64), 0
        hist, n_distinct = self._seg_hist(keys, counts,
                                          (n_bins, max_count, min_keep))
        return hist.cpu().numpy(), int(n_distinct)

    def counts_for(self, query_hi, query_lo) -> np.ndarray:
        """Total multiplicity of each query key (0 if absent), in query
        order, duplicates included: int64 numpy (compactor.py:610-653).
        Queries are (hi, lo) uint32 planes; the join is
        `_counts_for_bs`."""
        plane = self._sorted_plane()
        if plane is None:
            return np.zeros(len(query_hi), np.int64)
        if self.one_plane:
            assert not np.any(query_hi), (
                "counts_for: query keys exceed the declared key_bits <= 30")
        q = from_hi_lo(query_hi, query_lo, self.device)
        out = _counts_for_bs(*plane, q).cpu().numpy()
        if debug_enabled():
            _check_counts_for(plane, q, out)
        return out
