"""Deferred exact yak admission (port of kmer_tpu/pipeline/yak_admit.py,
single device).

The reference's pass-1 stderr lines (`[M] processed N sequences; M
distinct k-mers in the hash table`) need, per pipeline batch, the
running number of distinct keys the bloom-gated table has ADMITTED: a
key enters once `yak_bf_insert` finds all its probe bits already set,
with the bloom probed lane by lane.  Two identities make that a
handful of sorts at the end instead of per-block bloom work:

1. Only first occurrences matter to the bloom: every occurrence of key K
   probes the same bits, so "bit b is set before lane l" means "some key
   whose FIRST occurrence lane l1 < l probes b".
2. A key's second occurrence is always admitted (its own first one set
   its bits), so K enters at l1(K) if all its bits were set by earlier
   keys' first occurrences (a bloom false positive), else at l2(K) if it
   occurs twice, else never.

Streaming records (key, global lane index) only.  At the end:

  a. fold the stream to each key's first two occurrence lanes
     (`FirstSeenCompactor`; budget trips bound device memory);
  b. one (bit, l1) sort over n_hashes x keys probe entries: an entry is
     "pre-set" iff it is not the first of its bit's segment
     (`_fp_sort`), and the entries' verdicts return to probe order
     (`_fp_admits`);
  c. each key's admission lane is bucketed against the batch bounds and
     counted (`_admits_hist`).

Layout on the port: keys are biased int64 (kernels/keys.py; sentinel
INT64_MAX), lane indices int64 (sentinel INT64_MAX).  JAX's u32 index
reaches 2^32 - 2^26 (`_MAX_LANES`), which int32 would turn negative; the
guard stays, with its message, so that both packages accept the same
runs.

`ShardedDeferredYak` is the mesh form: one admission engine a shard, fed
with the shard's owned keys in stream order (dist/sharded.py `route`,
`all_to_all`), each with its own lane base and step bounds.  The JAX
package instead sends every device a fixed, sentinel-padded window of
lanes a step, so that one bounds vector serves all of them.

A block fed to the admission engine is a `yak.tap` span
(utils/trace.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels import bloom, merge
from ..kernels.keys import SENT
from ..kernels.segops import segment_starts
from ..utils import trace

IDX_SENT = (1 << 63) - 1  # lane-index sentinel (pads, "no second lane")
_MAX_LANES = (1 << 32) - (1 << 26)  # the JAX package's u32 index headroom
_BOUNDS_CLASSES = (32, 128, 1024, 8192)  # padded batch-count classes


def _sort_by_key(keys: torch.Tensor, idx: torch.Tensor):
    """Sort (key, idx) lanes by key with a stable sort: this is the
    (key, idx) order whenever idx already rises in input order within
    every key (a fresh chunk's iota)."""
    keys, order = torch.sort(keys, stable=True)
    return keys, idx[order]


def _first2_keep(keys: torch.Tensor, idx: torch.Tensor):
    """Each key's first TWO lanes of (key, idx)-sorted lanes, in order,
    sentinel lanes dropped (yak_admit.py:77-102).  Input may mix raw
    lanes and earlier first-2 lanes: the first two of the merged order
    are the first two overall, since every entry is a real occurrence."""
    starts = segment_starts(keys)
    second = torch.zeros_like(starts)
    second[1:] = starts[:-1] & ~starts[1:]
    keep = (starts | second) & (keys != SENT)
    return keys[keep], idx[keep]


def _first2_meta(keys: torch.Tensor, idx: torch.Tensor):
    """(starts, l2) on first-2 lanes: starts marks each distinct key's
    first lane (sentinels excluded); l2 is the key's second occurrence
    lane at its start, else IDX_SENT (yak_admit.py:135-147)."""
    same_prev = torch.zeros_like(keys, dtype=torch.bool)
    same_prev[1:] = keys[1:] == keys[:-1]
    starts = ~same_prev & (keys != SENT)
    next_same = torch.zeros_like(same_prev)
    next_same[:-1] = same_prev[1:]
    l2 = torch.where(next_same, torch.roll(idx, -1), IDX_SENT)
    return starts, l2


def _pack_ok(m: int, n_hashes: int) -> bool:
    """True when probe-entry flat positions fit 31 bits, the JAX
    package's condition for carrying (pos << 1) | verdict as one plane."""
    return m * n_hashes < (1 << 31)


def _fp_sort(keys: torch.Tensor, idx: torch.Tensor, spec: bloom.BloomSpec):
    """Bloom false-positive resolution, part A (yak_admit.py:156-198):
    probe entries of each key's START lane, sorted by (bit, l1).  An
    entry's verdict is "this bit was set before lane l1": it is not the
    first entry of its bit's segment.  Entries of equal (bit, l1) are one
    key's duplicate probes of a bit, which the reference also counts as
    set after the first (it tests each probe after setting the earlier
    ones of the same call); the stable sort keeps them in probe order,
    so the first of them takes the segment start's False.

    The sort key is (bit << 32) | l1: data bits are < 2^31 (the bloom is
    clamped to 2^31 bits) and l1 < 2^32, so it fits int64.  Entries of
    non-start lanes (second occurrences, sentinels) emit no probe and sort
    last as INT64_MAX; their verdicts are never read.  Returns the entry
    planes for `_fp_admits`: one plane (pos << 1) | verdict when
    `_pack_ok`, else (pos, verdict)."""
    starts, _ = _first2_meta(keys, idx)
    probes = bloom.probe_indices(keys, spec)
    l1 = idx.repeat(spec.n_hashes)
    fb = torch.cat([torch.where(starts, ix, -1) for ix in probes])
    sort_key = torch.where(fb >= 0, (fb << 32) | l1, SENT)
    s_key, s_pos = torch.sort(sort_key, stable=True)
    s_bit = s_key >> 32
    verdict = torch.zeros_like(s_bit)
    verdict[1:] = (s_bit[1:] == s_bit[:-1]).to(verdict.dtype)
    if _pack_ok(keys.shape[0], spec.n_hashes):
        return ((s_pos << 1) | verdict,)
    return s_pos, verdict


def _admits_hist(admitted: torch.Tensor, admit_idx: torch.Tensor,
                 bounds: torch.Tensor, n_bins: int):
    """Per-batch newly admitted counts (yak_admit.py:201-217).  bounds
    holds each batch's EXCLUSIVE end lane, ascending, sentinel-padded; a
    key admitted at lane x lands in batch sum(x >= bounds), histogram bin
    batch + 1 (bin 0 collects the lanes not admitted)."""
    batch = torch.searchsorted(bounds, admit_idx, right=True) + 1
    bins = torch.where(admitted, batch.clamp(max=n_bins - 1), 0)
    hist = torch.bincount(bins, minlength=n_bins)
    return hist, admitted.sum()


def _fp_admits(entries, keys: torch.Tensor, idx: torch.Tensor,
               bounds: torch.Tensor, n_hashes: int, n_bins: int):
    """Bloom false-positive resolution, part B (yak_admit.py:220-244):
    verdicts return to probe order (a sort of the packed plane, or a
    scatter by position), a lane is a false positive when all its probe
    verdicts are set, and a key enters the table at l1 when it is one,
    else at its second occurrence l2, else never.  Returns (admitted keys
    with the rest SENT, per-batch hist, total)."""
    m = keys.shape[0]
    if len(entries) == 1:
        sv = torch.sort(entries[0]).values & 1
    else:
        s_pos, verdict = entries
        sv = torch.empty_like(verdict)
        sv[s_pos] = verdict
    fp = sv.view(n_hashes, m).amin(0) == 1
    starts, l2 = _first2_meta(keys, idx)
    admitted = starts & (fp | (l2 != IDX_SENT))
    admit_idx = torch.where(fp, idx, l2)
    hist, tot = _admits_hist(admitted, admit_idx, bounds, n_bins)
    return torch.where(admitted, keys, SENT), hist, tot


def _admits_nobloom(keys: torch.Tensor, idx: torch.Tensor,
                    bounds: torch.Tensor, n_bins: int):
    """No bloom: every key is admitted at its first occurrence
    (yak_admit.py:247-255)."""
    starts, _ = _first2_meta(keys, idx)
    hist, tot = _admits_hist(starts, idx, bounds, n_bins)
    return torch.where(starts, keys, SENT), hist, tot


def _pad_bounds(bounds: List[int]) -> np.ndarray:
    n = max(1, len(bounds))
    for cls in _BOUNDS_CLASSES:
        if n <= cls:
            n = cls
            break
    else:
        raise ValueError(f"too many batches ({len(bounds)})")
    out = np.full((n,), IDX_SENT, np.int64)
    out[: len(bounds)] = np.asarray(bounds, np.int64)
    return out


class FirstSeenCompactor:
    """Accumulate (key, global lane index) lanes; keep, under a memory
    budget, a compacted run of each distinct key's first two occurrence
    lanes (yak_admit.py:265-417, its stream-sorted form).

    Each 2^24-lane chunk is sorted by (key, idx) as it arrives and
    carry-merged up a ladder of sorted runs with the (key, index) merge
    path (kernels/merge.py `merge_runs3`, out of place), so trips and the
    end pay merges and one keep pass, never a bulk re-sort.  The index is
    unique, so (key, idx) is a total order.  The budget counts 16 B a raw
    lane (key and index).

    `plain_kernels=True` merges with the plain PyTorch version on any
    device (as table.compactor.KmerCompactor)."""

    def __init__(self, device, budget_bytes: int = 1 << 30,
                 plain_kernels: bool = False):
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self._bytes = 0
        self._merge = (merge.merge_runs3_plain if plain_kernels
                       else merge.merge_runs3)
        self.stream = self._make_ladder()
        self._compacted: Optional[Tuple] = None  # the standing first-2 run
        self.trips = 0  # budget-trip compactions

    def _make_ladder(self):
        from ..table.compactor import _STREAM_CHUNK, _STREAM_MIN
        from ..table.stream_ladder import StreamLadder

        return StreamLadder(
            chunk=_STREAM_CHUNK,
            min_pad=_STREAM_MIN,
            # a chunk's idx plane is an iota: a stable key sort is the
            # (key, idx) order
            sort_fn=lambda p: _sort_by_key(*p),
            merge_fn=self._merge_runs,
            pad_fn=self._pad_run,
            concat_fn=lambda runs: tuple(
                torch.cat([r[i] for r in runs]) for i in range(2)),
            slice_fn=lambda p, a, b: tuple(x[a:b] for x in p),
            size_fn=lambda p: int(p[0].shape[0]),
        )

    def _merge_runs(self, a, b):
        """Merge two (key, idx)-sorted runs of any lengths into a new
        one."""
        return self._merge(a[0], a[1], b[0], b[1])

    @staticmethod
    def _pad_run(planes, target: int):
        n = planes[0].shape[0]
        if target == n:
            return planes
        return tuple(torch.cat([p, p.new_full((target - n,), s)])
                     for p, s in zip(planes, (SENT, IDX_SENT)))

    def add_raw(self, keys: torch.Tensor, base: int) -> None:
        n = int(keys.shape[0])
        idx = torch.arange(base, base + n, device=keys.device)
        self.stream.add((keys, idx))
        self._bytes += n * 16
        if self._bytes > self.budget_bytes:
            self.trips += 1
            self.compact()

    def compact(self) -> None:
        if not self.stream:
            return  # no new lanes since the last compact
        planes = self.stream.planes()
        self.stream.clear()
        if self._compacted is not None:
            # merge the standing first-2 run with the new sorted lanes
            # (the JAX package pads both to one power of two for its
            # bitonic network; a merge path takes unequal runs)
            planes = self._merge_runs(self._compacted, planes)
        keys, idx = self._compacted = _first2_keep(*planes)
        self._bytes = int(keys.shape[0]) * 16

    def first2_planes(self):
        """The compacted first-2 (keys, idx) planes, or None if nothing
        was ever added."""
        self.compact()
        return self._compacted


class DeferredYakAdmission:
    """Feed extracted key planes per block (with the reference's
    batch_end flags), then resolve every per-batch admitted-distinct
    total at once (yak_admit.py:433-490).  `spec` None (or use_bloom
    False) means no bloom: every valid k-mer is admitted at its first
    occurrence."""

    def __init__(self, spec: Optional[bloom.BloomSpec], use_bloom: bool,
                 budget_bytes: int = 1 << 30, device="cpu",
                 plain_kernels: bool = False):
        self.spec = spec
        self.use_bloom = bool(use_bloom and spec is not None)
        self.fs = FirstSeenCompactor(device, budget_bytes, plain_kernels)
        self._base = 0
        self.bounds: List[int] = []  # exclusive end lane per batch
        self._pending = False

    def add_block(self, keys: torch.Tensor, batch_end: bool) -> None:
        """Append one block's lanes; the lane base counts every lane of
        the plane, sentinels included."""
        n = int(keys.shape[0])
        if self._base + n > _MAX_LANES:
            raise RuntimeError(
                "yak admission simulation exceeds the u32 lane-index "
                "range (~4.2 Gbases per run); rerun with "
                "KMER_TPU_FAST_YAK=1 to skip the stderr simulation"
            )
        with trace.span("yak.tap"):
            self.fs.add_raw(keys, self._base)
        self._base += n
        self._pending = True
        if batch_end:
            self.close_step()

    def close_step(self) -> None:
        """End the current batch at the lanes added so far (a batch that
        added none still gets its bound)."""
        self.bounds.append(self._base)
        self._pending = False

    def finish(self) -> Tuple[np.ndarray, int]:
        """(per-batch newly admitted counts, total admitted).  Call once,
        after the last block."""
        _keys, per_batch, tot = self.resolve()
        return per_batch, tot

    def resolve(self):
        """(admitted keys, per-batch newly admitted counts, total
        admitted): the admitted keys are key-sorted, the lanes not
        admitted SENT (None when nothing was added).  Call once, after
        the last block."""
        if self._pending:
            self.close_step()
        planes = self.fs.first2_planes()
        if not self.bounds or planes is None:
            return None, np.zeros((len(self.bounds),), np.int64), 0
        keys, idx = planes
        bounds = torch.from_numpy(_pad_bounds(self.bounds)).to(keys.device)
        n_bins = int(bounds.shape[0]) + 2
        if self.use_bloom:
            entries = _fp_sort(keys, idx, self.spec)
            keys, hist, tot = _fp_admits(entries, keys, idx, bounds,
                                         self.spec.n_hashes, n_bins)
        else:
            keys, hist, tot = _admits_nobloom(keys, idx, bounds, n_bins)
        per_batch = hist.cpu().numpy().astype(np.int64)[
            1: len(self.bounds) + 1]
        return keys, per_batch, int(tot)


class ShardedDeferredYak:
    """The mesh form (yak_admit.py:625-704): one DeferredYakAdmission a
    shard, fed each step with the shard's owned keys.

    Keys can meet in the bloom only through a shared probe bit, a bit
    lies in one prefix subtable, and the prefix's low owner_bits are the
    owner (BloomSpec.owner_bits), so every (bit, l1) comparison is within
    one shard.  A shard's lanes arrive in global stream order restricted
    to its keys (dist.sharded `route` and `all_to_all`), so its own lane
    count is a valid lane index.  The JAX package gives every device the
    same padded lane count a step and so one shared bounds vector; here
    each shard has its own lane base and bounds, one bound a step, and
    the per-step counts are summed over the shards after `finish`.
    budget_bytes applies per shard."""

    def __init__(self, mesh, spec: Optional[bloom.BloomSpec],
                 use_bloom: bool, budget_bytes: int = 1 << 30,
                 plain_kernels: bool = False):
        self.mesh = mesh
        self.shards = [
            DeferredYakAdmission(spec, use_bloom, budget_bytes, dev,
                                 plain_kernels)
            for dev in mesh.devices]

    def add_chunk(self, owned, step_end: bool = True) -> None:
        """One step's owned keys, a tensor a shard (a shard that owns no
        key this step still closes the step)."""
        for adm, keys in zip(self.shards, owned):
            if keys.shape[0]:
                adm.add_block(keys, step_end)
            elif step_end:
                adm.close_step()

    def finish(self):
        """(admitted keys a shard, per-step newly admitted counts summed
        over the shards and the processes, total admitted).  A shard's admitted keys are
        key-sorted with the rest SENT, as the shrink join takes them;
        empty for a shard that owns no key."""
        keys, per_step, tot = [], 0, 0
        for adm in self.shards:
            k, ps, t = adm.resolve()
            keys.append(k if k is not None else torch.full(
                (0,), SENT, dtype=torch.int64, device=adm.fs.device))
            per_step, tot = per_step + ps, tot + t
        if self.mesh.n_proc > 1:  # every process has stepped alike
            from ..dist.sharded import allreduce_ints

            both = allreduce_ints([*per_step, tot])
            per_step, tot = both[:-1], int(both[-1])
        return keys, per_step, tot
