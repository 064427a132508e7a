"""yak-count's engines (port of kmer_tpu/pipeline/yak.py: the constants,
`_yak_ingest_core`, `_clamp_bf_shift`, `_exact_bloom_default`,
`_bloom_geometry_ok`, `_make_bloom`, `_tap_admit`, `YakSimTap`,
`YakEngine`, `_mesh_row_batches`, `MeshYakEngine`, `_shrink_join_core`,
`SortYakEngine`, `MeshSortYakEngine`, `make_yak_engine`,
`yak_count_file`).

Single-file yak-count counts on the sort engine (pipeline/counter.py);
`YakSimTap` rides the engine's extracted key planes and gives the
reference's per-batch `[M] processed N sequences; M distinct k-mers in
the hash table` totals through the deferred admission engine
(pipeline/yak_admit.py).

Two-file yak-count runs `SortYakEngine` (yak_count_file, the
reference's yak_count_file flow): pass 1 gates file 1's k-mers with the
bloom's bits array (kernels/bloom.py, sequential test-and-set by
default) and counts the admitted lanes in one compactor; pass 2 counts
file 2 in a second compactor; the shrink joins the two by one stable
sort.

On the mesh (pipeline/counter.py `use_mesh`), and in a run of several
processes (dist/multihost.py), two-file yak-count runs
`MeshSortYakEngine`: no bits array; each step's k-mers are routed to
their owners (dist/sharded.py, ragged owner buckets in stream order
where the JAX package sends sentinel-padded windows of fixed width),
pass 1's admission resolves per shard when the pass ends
(pipeline/yak_admit.py `ShardedDeferredYak`), and the shrink join runs
per shard and sums.

The bits array is packed (kernels/bloom.py, 2^(b - 3) bytes).
SortYakEngine holds the -b asked for, up to 2^38 bits (32 GiB) on its
one device; the other engines clamp at 2^31 bits a device, as the JAX
package does (`_clamp_bf_shift`): the table engine's checkpoints are
the JAX package's byte-per-bit layout, the mesh engines follow the JAX
mesh, and the single-file tap's deferred admission packs bit << 32 |
lane (pipeline/yak_admit.py).

KMER_TPU_TABLE_YAK=1 runs the open-addressing table engines instead, as
in the JAX package: `YakEngine` on one device and `MeshYakEngine` on the
mesh or across processes.  Each block's bloom gate and insert go into a
count table (table/count_table.py, its slot resolution csrc/table.cu on
the card) whose planes equal the JAX engine's; `YakEngine` saves and
resumes between the passes in the JAX package's checkpoint layout.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import bloom
from ..kernels.bloom import BLK_SHIFT, BloomSpec
from ..kernels.keys import SENT
from ..table import count_table as ct
from ..table.compactor import KmerCompactor
from ..utils import trace
from ..utils.log import warn
from .counter import (GROW_LOAD, IngestStats, _extracted_blocks, mesh_steps,
                      use_mesh)

YAK_COUNTER_BITS = 10  # yak-count.c:9
YAK_N_COUNTS = 1 << YAK_COUNTER_BITS
YAK_MAX_COUNT = YAK_N_COUNTS - 1
# the largest bloom a device holds, log2 bits: the JAX package's, which
# every engine but SortYakEngine keeps, and SortYakEngine's (32 GiB)
CLAMP_SHIFT = 31
SORT_MAX_SHIFT = 38


def _yak_ingest_core(table: ct.CountTable, bits: torch.Tensor,
                     keys: torch.Tensor, spec, create_new: bool,
                     use_bloom: bool, exact_bloom: bool = False,
                     plain_kernels: bool = False):
    """The bloom gate and table insert of one block of sentinelized keys
    (yak.py:55-93, yak_ch_insert_list, yak-count.c:150-177): valid lanes
    are the non-sentinel ones.  Pass 1 (create_new) sets the bloom bits
    (the sequential test-and-set with exact_bloom) and inserts gated by
    them, or inserts every lane without a bloom; pass 2 increments keys
    already present.  Returns (table, bits, n_new, n_dead), the last
    two 0-dim int64 tensors; bits is updated in place."""
    valid = keys != SENT
    n_dead = torch.zeros((), dtype=torch.int64, device=keys.device)
    if not create_new:
        table = ct.add_existing(table, keys, valid, YAK_MAX_COUNT,
                                plain_kernels=plain_kernels)
        return table, bits, torch.zeros_like(n_dead), n_dead
    if use_bloom:
        ins = _insert_fn(exact_bloom, plain_kernels)
        bits, preset = ins(bits, keys, valid, spec)
        table, n_new, n_dead = ct.insert_gated(table, keys, valid, preset,
                                               YAK_MAX_COUNT, plain_kernels)
    else:
        table, n_new = ct.insert(table, keys, valid, YAK_MAX_COUNT,
                                 plain_kernels=plain_kernels)
    return table, bits, n_new, n_dead


def _insert_fn(exact_bloom: bool, plain_kernels: bool):
    """The bloom's test-and-set: sequential with exact_bloom, else
    batched; the plain version under plain_kernels."""
    if exact_bloom:
        return (bloom.insert_sequential_plain if plain_kernels
                else bloom.insert_sequential)
    return bloom.insert_plain if plain_kernels else bloom.insert


def _clamp_bf_shift(bf_shift: int, owner_bits: int = 0,
                    max_shift: int = CLAMP_SHIFT) -> int:
    """The largest bloom is 2^max_shift bits per device: 2^31 for every
    engine but SortYakEngine (the JAX package's limit, kept so both
    admit the same keys), 2^38 for it; a larger -b clamps with a warning
    (yak.py:105-124).  Single-file output does not depend on the bloom's
    size."""
    cap = max_shift + owner_bits
    if bf_shift > cap:
        warn("yak_count",
             f"bloom size 2^{bf_shift} exceeds the per-device budget; "
             f"using 2^{cap} bits")
        return cap
    return bf_shift


def _bloom_geometry_ok(bf_shift: int, pre: int, owner_bits: int = 0,
                       max_shift: int = CLAMP_SHIFT) -> bool:
    """True when the (possibly clamped) bloom still holds at least one
    512-bit block per -p subtable; else the bloom is disabled with a
    warning (yak.py:141-155)."""
    clamped = min(bf_shift, max_shift + owner_bits)
    if clamped - pre >= BLK_SHIFT:
        return True
    warn("yak_count",
         f"clamped bloom (2^{clamped} bits) leaves fewer than one "
         f"512-bit block per -p{pre} subtable; bloom prefilter disabled")
    return False


def _exact_bloom_default(use_bloom: bool) -> bool:
    """The sequential test-and-set (bloom.insert_sequential) is on with
    the bloom unless KMER_TPU_EXACT_BLOOM is 0/false/off/no, which takes
    the batched insert (strictly fewer false positives; yak.py:127-138)."""
    return bool(use_bloom) and os.environ.get(
        "KMER_TPU_EXACT_BLOOM", "1").strip() not in ("0", "false", "off",
                                                      "no")


def _make_bloom(pre: int, bf_shift: int, bf_n_hash: int,
                make_bits_array: bool = True, device=None,
                max_shift: int = CLAMP_SHIFT):
    """The one bloom-geometry gate of both yak paths (yak.py:160-185):
    (use_bloom, bf_shift, spec, bits, exact_bloom).  The gates mirror
    yak_ch_init (n_shift > pre) and yak_bf_init (BLK_SHIFT <= n_shift -
    pre); -b clamps at max_shift.  bits is the bloom's zeroed packed bits
    array on `device`, an 8-byte dummy without a bloom, and None with
    make_bits_array=False (the single-file tap needs the spec only)."""
    use_bloom = (
        bf_n_hash > 0
        and bf_shift > pre
        and (bf_shift - pre) >= BLK_SHIFT
        and _bloom_geometry_ok(bf_shift, pre, max_shift=max_shift)
    )
    if use_bloom:
        bf_shift = _clamp_bf_shift(bf_shift, max_shift=max_shift)
        spec = BloomSpec(pre, bf_shift, bf_n_hash)
        bits = bloom.make_bits(spec, device) if make_bits_array else None
    else:
        spec = None
        bits = (torch.zeros(8, dtype=torch.uint8, device=device)
                if make_bits_array else None)
    return use_bloom, bf_shift, spec, bits, _exact_bloom_default(use_bloom)


def _tap_admit(bits, keys, spec, use_bloom, exact_bloom,
               plain_kernels: bool = False):
    """Per-lane admission of pass 1 (yak.py:188-204): a lane is admitted
    iff the reference's yak_bf_insert would return n_hash for it (all
    its bits set before it, by earlier blocks or, under the sequential
    semantics, earlier lanes of this block); the rest become the
    sentinel (bloom.admit: one kernel call on the card, the plain
    version under plain_kernels).  Without a bloom every valid lane is
    admitted.  Returns (keys, bits), bits updated in place."""
    if not use_bloom:
        return keys, bits
    return bloom.admit(bits, keys, spec, exact_bloom, plain_kernels), bits


class YakSimTap:
    """Single-file stderr progress simulation (yak.py:263-327): per
    block, record the key plane in the deferred admission engine; at the
    end, resolve every batch's admitted-distinct total and call
    log(n_seqs, running_total) once per batch.

    KMER_TPU_TAP_BUDGET (bytes, default 2 GiB) is the admission
    compactor's budget, as in the JAX package.  `device` is the engine's;
    `plain_kernels` makes the admission merges use the plain PyTorch
    version (kernels/merge.py), as the engine's own switch does."""

    def __init__(self, pre=10, bf_shift=0, bf_n_hash=4, log=None,
                 device=None, plain_kernels: bool = False):
        from .. import default_device
        from .yak_admit import DeferredYakAdmission

        self.log = log
        self.use_bloom, _bf, self.spec, _bits, _exact = _make_bloom(
            pre, bf_shift, bf_n_hash, make_bits_array=False)
        budget = int(os.environ.get("KMER_TPU_TAP_BUDGET", str(2 << 30)))
        self.adm = DeferredYakAdmission(
            self.spec, self.use_bloom, budget_bytes=budget,
            device=device if device is not None else default_device(),
            plain_kernels=plain_kernels)
        self.tot = 0
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def begin_batches(self) -> None:
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def ingest_planes(self, keys, n_valid, n_seqs, batch_end) -> None:
        """The engine's tap: one block's key plane (count_paths)."""
        self.adm.add_block(keys, bool(batch_end))
        self._batch_seqs += int(n_seqs)
        if batch_end:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0

    def finish_batches(self) -> None:
        if self._batch_seqs or self.adm._pending:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0
        per_batch, self.tot = self.adm.finish()
        if self.log is not None:
            running = 0
            for n_seqs, new in zip(self.batch_seq_counts, per_batch):
                running += int(new)
                self.log(n_seqs, running)

    @property
    def budget_trips(self) -> int:
        return self.adm.fs.trips


class YakEngine:
    """The open-addressing two-pass yak engine on one device
    (yak.py:330-502): every block's bloom gate and insert go into one
    count table (`_yak_ingest_core`), grown before a batch could pass
    GROW_LOAD; `[M` lines a reader batch, as the reference prints them.

    `device` defaults to default_device(); `plain_kernels` makes the
    extraction and the slot resolution take their plain PyTorch
    versions.  `stats` holds one IngestStats a `count` call; `rebuilds`
    counts the table's rebuilds (growth and tombstone sweeps)."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, init_capacity=1 << 20, log=None,
                 device=None, plain_kernels: bool = False):
        from .. import default_device
        from ..kernels import extract

        self.device = torch.device(device) if device is not None \
            else default_device()
        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.chunk_size = chunk_size
        # one reference batch a buffer: separators' headroom
        self.capacity_block = int(chunk_size) + max(4096, chunk_size // 32)
        self.log = log
        self.plain_kernels = plain_kernels
        self._extract = (extract.extract_keys_plain if plain_kernels
                         else extract.extract_keys)
        self._extract_rows = (extract.extract_keys_rows_plain
                              if plain_kernels else extract.extract_keys_rows)
        self.batch_seq_counts = []  # per-batch n_seqs of the last count()
        self._batch_seqs, self._batch_pending = 0, False
        self.table = ct.make(init_capacity, self.device)
        self._n_dead = 0  # DELETED tombstones since the last rebuild
        self.rebuilds = 0
        (self.use_bloom, self.bf_shift, self.spec, self.bits,
         self.exact_bloom) = _make_bloom(pre, bf_shift, bf_n_hash,
                                         device=self.device)
        self.tot = 0  # cumulative distinct insertions (yak's h->tot)
        self.stats = []

    def _rebuild(self, cap: int, min_count: int = 0, max_count=None):
        self.table = ct.rebuild(self.table, cap, min_count, max_count,
                                self.plain_kernels)
        self._n_dead = 0  # the rebuild swept the tombstones
        self.rebuilds += 1

    def _maybe_grow(self, incoming: int = 0) -> None:
        """Keep FULL slots, tombstones and a worst case of `incoming` new
        keys under GROW_LOAD (yak.py:361-383): the slot resolution ends
        only while free slots outnumber a batch's distinct keys.  The new
        capacity is sized from live keys alone, since the rebuild sweeps
        the tombstones."""
        n_full = int(self.table.n_full)
        cap = self.table.capacity
        while n_full + incoming > GROW_LOAD * cap:
            cap *= 2
        if (cap != self.table.capacity
                or n_full + self._n_dead + incoming
                > GROW_LOAD * self.table.capacity):
            self._rebuild(cap)

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        """One pass over `paths`, `[M` lines at the reader's batch ends
        (yak-count.c:427)."""
        st = IngestStats()
        self.stats.append(st)
        t_loop = time.perf_counter()
        self.begin_batches()
        for keys, nk, _nb, n_seqs, batch_end in _extracted_blocks(
                paths, self.k, self.chunk_size, self.capacity_block,
                ("resume", self.k, 3), self.device, True, self._extract,
                self._extract_rows, st):
            t1 = time.perf_counter()
            self.ingest_planes(keys, nk, n_seqs, batch_end, create_new)
            st.dispatch_s += time.perf_counter() - t1
        self.finish_batches()
        st.loop_s = time.perf_counter() - t_loop

    def begin_batches(self) -> None:
        self.batch_seq_counts = []
        self._batch_seqs, self._batch_pending = 0, False

    def ingest_planes(self, keys, n_valid, n_seqs, batch_end,
                      create_new: bool = True) -> None:
        """One extracted block (lanes in read order) through the bloom
        gate and the table, with the per-batch `[M` accounting."""
        if create_new:
            # worst case: every valid lane a new key; tombstones count
            # in the load, as they are probe-opaque
            self._maybe_grow(incoming=int(n_valid))
        self.table, self.bits, n_new, n_dead = _yak_ingest_core(
            self.table, self.bits, keys, self.spec, create_new,
            self.use_bloom, self.exact_bloom, self.plain_kernels)
        if create_new:
            self.tot += int(n_new)
            self._n_dead += int(n_dead)
        self._batch_seqs += int(n_seqs)
        self._batch_pending = True
        if batch_end:
            self._flush_batch()

    def _flush_batch(self) -> None:
        if self.log is not None:
            self.log(self._batch_seqs, self.tot)
        self.batch_seq_counts.append(self._batch_seqs)
        self._batch_seqs, self._batch_pending = 0, False

    def finish_batches(self) -> None:
        """The last, partial batch prints too (the reference runs its
        steps on sum_len > 0 at EOF)."""
        if self._batch_pending:
            self._flush_batch()

    def destroy_bloom(self) -> None:
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        self.bits = torch.zeros(8, dtype=torch.uint8, device=self.device)

    def clear(self) -> None:
        self.table = ct.clear_counts(self.table)

    def shrink(self, min_count: int, max_count: int) -> None:
        self._rebuild(self.table.capacity, min_count, max_count)
        self.tot = int(self.table.n_full)

    def hist(self) -> np.ndarray:
        return ct.hist(self.table, YAK_N_COUNTS).cpu().numpy()

    def save_checkpoint(self, path: str) -> None:
        """The table and the bloom's bits in the JAX package's npz layout
        (yak.py:463-482): state uint8, key_hi / key_lo / cnt uint32, bits
        uint8 one byte a bit (the packed array unpacked), meta =
        int64[k, pre, bf_shift, bf_n_hash, n_full, tot, use_bloom,
        chunk_size]; written to a temporary file and renamed.  Between
        the passes, so a killed pass 2 resumes without pass 1."""
        state, hi, lo, cnt = ct.to_jax_planes(self.table)
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp, state=state, key_hi=hi, key_lo=lo, cnt=cnt,
            bits=(bloom.unpack_bits(self.bits) if self.use_bloom
                  else self.bits).cpu().numpy(),
            meta=np.asarray(
                [self.k, self.pre, self.bf_shift, self.bf_n_hash,
                 int(self.table.n_full), self.tot, int(self.use_bloom),
                 self.chunk_size], np.int64))
        os.replace(tmp, path)

    @classmethod
    def resume_checkpoint(cls, path: str, log=None, device=None,
                          plain_kernels: bool = False) -> "YakEngine":
        """An engine from a checkpoint that either package wrote."""
        z = np.load(path)
        k, pre, bfs, bfh, n_full, tot, use_bloom, chunk = (
            int(x) for x in z["meta"])
        eng = cls(k=k, pre=pre, bf_shift=bfs, bf_n_hash=bfh,
                  chunk_size=chunk, init_capacity=1, log=log, device=device,
                  plain_kernels=plain_kernels)
        eng.table = ct.from_jax_planes(z["state"], z["key_hi"], z["key_lo"],
                                       z["cnt"], n_full, eng.device)
        eng.tot = tot
        if use_bloom:
            eng.bits = bloom.pack_bits(torch.from_numpy(z["bits"])).to(
                eng.device)
        else:
            eng.destroy_bloom()
        return eng


def _shrink_join_core(keys1: torch.Tensor, keys2: torch.Tensor,
                      c2: torch.Tensor, min_count: int, max_count: int):
    """The counts of the pass-1 keys (A) in the pass-2 run (B), as one
    sorted merge-join (yak.py:928-962): A's run, then B's, go through
    one stable sort of the biased key, which puts each A entry just
    before its B partner (each run holds a key once); an A entry takes
    its neighbour's count, saturates it at YAK_MAX_COUNT, and is kept
    when it lies in [min_count, max_count]; a 1024-bin bincount counts
    the kept ones, the others in bin 0 (min_count >= 1; the caller
    clears bin 0, as JAX's shrink does).  Sentinel lanes of A never
    count.  c2 holds uint32 counts in int32 lanes.  Returns (hist
    int64[1024], tot as a 0-dim tensor)."""
    n1 = keys1.shape[0]
    keys = torch.cat([keys1, keys2])
    from_b = torch.ones_like(keys, dtype=torch.bool)
    from_b[:n1] = False
    cnt = torch.zeros_like(keys)
    cnt[n1:] = c2.to(torch.int64) & 0xFFFFFFFF
    s, order = torch.sort(keys, stable=True)
    from_b, cnt = from_b[order], cnt[order]
    take_next = (s[1:] == s[:-1]) & ~from_b[:-1] & from_b[1:]
    a_cnt = torch.zeros_like(cnt)
    a_cnt[:-1] = torch.where(take_next, cnt[1:], 0)
    c = a_cnt.clamp(max=YAK_MAX_COUNT)
    keep = ~from_b & (s != SENT) & (c >= min_count) & (c <= max_count)
    hist = torch.bincount(torch.where(keep, c, 0), minlength=YAK_N_COUNTS)
    return hist, keep.sum()


def _counts_hist(c1: torch.Tensor, min_count: int = 1,
                 max_count: int = YAK_MAX_COUNT):
    """(histogram int64[1024], kept) of a compacted run's counts (uint32
    in int32 lanes), saturated at YAK_MAX_COUNT and kept in [min_count,
    max_count]: the host bincount of yak.py:1089-1096 and :1109-1114."""
    c = np.minimum(c1.cpu().numpy().view(np.uint32).astype(np.int64),
                   YAK_MAX_COUNT)
    keep = (c >= min_count) & (c <= max_count)
    return (np.bincount(c[keep], minlength=YAK_N_COUNTS)[:YAK_N_COUNTS],
            int(keep.sum()))


class SortYakEngine:
    """Sort-based two-pass yak engine on one device (yak.py:999-1114).

    With the sequential bloom, every occurrence of a key after its first
    admitted one sees all its bits set, so pass-1 counts are the
    multiplicities of the bloom-admitted lanes: those flow through a
    sort-based compactor (`comp1`) directly.  Pass 2 counts file 2 in a
    second compactor (`comp2`), and `shrink` joins the pass-1 keys
    against it (`_shrink_join_core`).  The bloom is the size asked for,
    up to 2^SORT_MAX_SHIFT bits, packed (16 GiB at -b37).

    Spans (utils/trace.py): `yak.pass` a pass (`pass` 1 or 2, `bases`
    read), the count loop's span for the reader's, staging's and
    dispatch's spans under it, as SortCountEngine.count_paths's
    `count.loop` is; `yak.bloom` a block's admission (`lanes`, the
    block's valid lanes, a 0-dim tensor); `yak.shrink` the shrink.

    `device` defaults to default_device(); `plain_kernels` makes both
    compactors call the kernels' plain versions (and extraction too), as
    SortCountEngine's switch does.  `stats` holds one IngestStats a
    `count` call (dispatch includes the batch-end compactions)."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, log=None, device=None,
                 plain_kernels: bool = False):
        from .. import default_device
        from ..kernels import extract

        self.device = torch.device(device) if device is not None \
            else default_device()
        self.k = k
        self.log = log
        self.chunk_size = chunk_size
        self.capacity_block = int(chunk_size) + max(4096, chunk_size // 32)
        self.plain_kernels = plain_kernels
        self._extract = (extract.extract_keys_plain if plain_kernels
                         else extract.extract_keys)
        self._extract_rows = (extract.extract_keys_rows_plain
                              if plain_kernels else extract.extract_keys_rows)
        (self.use_bloom, self.bf_shift, self.spec, self.bits,
         self.exact_bloom) = _make_bloom(pre, bf_shift, bf_n_hash,
                                         device=self.device,
                                         max_shift=SORT_MAX_SHIFT)
        self.comp1 = self._mk()  # admitted-occurrence stream (pass 1)
        self.comp2 = None        # file 2's occurrence stream (pass 2)
        self.tot = 0
        self._hist = None        # post-shrink histogram (host)
        self.batch_seq_counts = []
        self._batch_seqs = 0
        self.stats = []

    def _mk(self) -> KmerCompactor:
        return KmerCompactor(self.device, key_bits=2 * self.k,
                             plain_kernels=self.plain_kernels)

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        """One pass: pass 1 (create_new) admits through the bloom into
        comp1, pass 2 counts into comp2; one `_flush_batch` a reader
        batch end, and one more for a pending tail."""
        self.batch_seq_counts = []
        self._batch_seqs = 0
        pending = False
        st = IngestStats()
        self.stats.append(st)
        t_loop = time.perf_counter()
        bases = 0
        with trace.span("yak.pass", **{"pass": 1 if create_new else 2}) \
                as sp:
            for keys, nk, nb, n_seqs, batch_end in _extracted_blocks(
                    paths, self.k, self.chunk_size, self.capacity_block,
                    ("resume", self.k, 3), self.device, True, self._extract,
                    self._extract_rows, st, sp):
                with trace.timed("ingest.dispatch", sp) as d:
                    bases += int(nb)
                    if create_new:
                        with trace.span("yak.bloom", lanes=nk):
                            keys, self.bits = _tap_admit(
                                self.bits, keys, self.spec, self.use_bloom,
                                self.exact_bloom, self.plain_kernels)
                        self.comp1.add_raw(keys)
                    else:
                        self.comp2.add_raw(keys)
                    self._batch_seqs += int(n_seqs)
                    pending = True
                    if batch_end:
                        self._flush_batch(create_new)
                        pending = False
                st.dispatch_s += d.seconds
            if pending:
                self._flush_batch(create_new)
            sp.set(bases=bases)
        st.loop_s = time.perf_counter() - t_loop

    def _flush_batch(self, create_new: bool) -> None:
        if create_new:
            self.comp1.compact()
            self.tot = self.comp1.last_n_unique
        # pass 2 never inserts: every line repeats the pass-1 total
        # (yak-count.c:170-174)
        if self.log is not None:
            self.log(self._batch_seqs, self.tot)
        self.batch_seq_counts.append(self._batch_seqs)
        self._batch_seqs = 0

    def destroy_bloom(self) -> None:
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        self.bits = torch.zeros(8, dtype=torch.uint8, device=self.device)

    def clear(self) -> None:
        # pass-2 counts go to their own compactor; the pass-1 keys (the
        # membership set) stay in comp1
        self.comp2 = self._mk()

    def shrink(self, min_count: int, max_count: int) -> None:
        """Resolve the pass-1 key set against the pass-2 counts (the
        yak_ch_shrink rebuild, yak-count.c:243-277); stores the final
        histogram and tot."""
        with trace.span("yak.shrink"):
            self._shrink(min_count, max_count)

    def _shrink(self, min_count: int, max_count: int) -> None:
        self.comp1.compact()
        keys1, c1 = self.comp1.runs[0]
        if self.comp2 is None:
            self._hist, self.tot = _counts_hist(c1, min_count, max_count)
            return
        self.comp2.compact()
        keys2, c2 = self.comp2.runs[0]
        h, tot = _shrink_join_core(keys1, keys2, c2, min_count, max_count)
        self._hist = h.cpu().numpy()
        self._hist[0] = 0  # bin 0 counts the dropped lanes
        self.tot = int(tot)

    def hist(self) -> np.ndarray:
        if self._hist is not None:
            return self._hist
        # bf_shift == 0: pass-1 counts, no shrink
        self.comp1.compact()
        return _counts_hist(self.comp1.runs[0][1])[0]


def _mesh_row_batches(eng, paths: Sequence[str], st: IngestStats):
    """The mesh yak engine's steps (yak.py:508-598), ASCII ingest always.
    Yields (this process's rows, row_bytes, the step's n_seqs).

    One process: n_dev reader blocks of row_bases bases a step
    (capacity_block = row_bases + 4096), the last step short, row_bytes
    kept only when every row shares it.

    Several processes: each reads its own files (dist.multihost
    `shard_files`) in n_local blocks of row_bases bases, row_bases wide,
    every process stepping in lockstep and n_seqs summed over them.
    KMER_TPU_SINGLE_READER=1 instead has process 0 read every file and
    broadcast global batches of capacity_block-wide rows: batch
    composition, bloom admission order and the `[M` lines then match a
    1-process run of the same mesh (PARITY.md divergences 8 and 10)."""
    pin = any(d.type == "cuda" for d in eng.mesh.devices)
    policy = ("resume", eng.k, 3)
    if eng.mesh.n_proc > 1:
        from ..dist import multihost

        for rows, rb, _nb, ns in multihost.process_steps(
                paths, eng.k, eng.row_bases, eng.mesh, policy, pin, True, st,
                capacity=eng.capacity_block):
            yield rows, rb, ns
        return
    for rows, rb, _aux, _ingest, _nb, n_seqs in mesh_steps(
            paths, eng.k, eng.row_bases, eng.capacity_block, policy,
            eng.n_dev, False, pin, True, st):
        yield rows, rb, n_seqs


class MeshYakEngine:
    """YakEngine on the mesh (yak.py:601-772): every structure partitioned
    by key ownership, the routing of dist.sharded.ShardedSortEngine.
    Each shard holds the bloom bits and the table slots of the keys it
    owns, so yak_ch_insert_list's gate and insert (yak-count.c:150-177)
    run shard-local after the exchange (dist.sharded
    `sharded_yak_ingest`); clear, shrink and hist are per-shard with
    summed results.  Bloom probe values equal the single-device ones
    (BloomSpec.owner_bits), and each owner's lanes arrive in global
    stream order, so the sequential bloom is exact shard by shard.  One
    `[M` line a mesh step.  `devices` and `plain_kernels` as
    MeshSortYakEngine's; `rebuilds` as YakEngine's."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, init_capacity=1 << 16, log=None,
                 devices=None, plain_kernels: bool = False):
        from ..dist import sharded

        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.log = log
        self.mesh = sharded.make_mesh(devices)
        self.n_dev = self.mesh.size
        self.device = self.mesh.devices[0]
        self.owner_bits = self.n_dev.bit_length() - 1
        self.plain_kernels = plain_kernels
        self.row_bases = max(int(chunk_size) // self.n_dev, 1 << 16)
        self.capacity_block = self.row_bases + 4096
        self.cap_local = init_capacity
        self.tables = sharded.make_sharded_tables(self.mesh, init_capacity)
        bloom_wanted = (bf_n_hash > 0 and bf_shift > pre
                        and (bf_shift - pre) >= BLK_SHIFT)
        self.use_bloom = (bloom_wanted and pre >= self.owner_bits
                          and _bloom_geometry_ok(bf_shift, pre,
                                                 self.owner_bits))
        if bloom_wanted and not self.use_bloom:
            # the per-shard bloom partition needs at least one prefix bit
            # per owner; with fewer, pass 1 admits every key
            warn("yak_count",
                 f"-p{pre} has fewer prefix bits than the {self.n_dev}"
                 f"-device mesh needs ({self.owner_bits}); bloom "
                 "prefilter disabled (two-file admission differs from "
                 "a single-chip run)")
        if self.use_bloom:
            self.bf_shift = _clamp_bf_shift(bf_shift, self.owner_bits)
            self.spec = BloomSpec(pre, self.bf_shift, bf_n_hash,
                                  self.owner_bits)
            self.bits = [bloom.make_bits(self.spec, d)
                         for d in self.mesh.devices]
        else:
            self.spec = None
            self.bits = [torch.zeros(8, dtype=torch.uint8, device=d)
                         for d in self.mesh.devices]
        self.exact_bloom = _exact_bloom_default(self.use_bloom)
        self.tot = 0
        self._n_dead = 0  # the worst shard's tombstones since a rebuild
        self.rebuilds = 0
        self._route = sharded.ShardedSortEngine(self.mesh, k,
                                                plain_kernels=plain_kernels)
        self.stats = []

    def _rebuild(self, cap: int, min_count: int = 0, max_count=None):
        from ..dist import sharded

        self.tables = sharded.sharded_rebuild(self.tables, cap, min_count,
                                              max_count, self.plain_kernels)
        self._n_dead = 0  # the rebuild swept the tombstones
        self.cap_local = cap
        self.rebuilds += 1

    def _maybe_grow(self, incoming: int) -> None:
        """Size every shard's table for the worst-case step (yak.py:
        704-723): one capacity for all, grown to the fullest shard's
        need; the worst shard's tombstones count and are swept."""
        from ..dist import sharded

        n_full = sharded.sharded_nfull_stats(self.mesh, self.tables)[0]
        cap = self.cap_local
        while n_full + incoming > GROW_LOAD * cap:
            cap *= 2
        if (cap != self.cap_local
                or n_full + self._n_dead + incoming
                > GROW_LOAD * self.cap_local):
            self._rebuild(cap)

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        st = IngestStats()
        self.stats.append(st)
        t_loop = time.perf_counter()
        for rows, rb, n_seqs in _mesh_row_batches(self, paths, st):
            t1 = time.perf_counter()
            self._step_rows(rows, rb, n_seqs, create_new)
            st.dispatch_s += time.perf_counter() - t1
        st.loop_s = time.perf_counter() - t_loop

    def _step_rows(self, rows, rb, n_seqs: int, create_new: bool) -> None:
        from ..dist import sharded

        owned = self._route.route_batch(rows, row_bytes=rb)
        if create_new:
            self._maybe_grow(sharded.sharded_valid_max(self.mesh, owned))
        self.tables, self.bits, n_new, n_dead = sharded.sharded_yak_ingest(
            self.mesh, self.tables, self.bits, owned, self.spec, create_new,
            self.use_bloom, self.exact_bloom, self.plain_kernels)
        if create_new:
            self.tot += n_new
            self._n_dead += n_dead
        if self.log is not None:
            self.log(n_seqs, self.tot)

    def destroy_bloom(self) -> None:
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        self.bits = [torch.zeros(8, dtype=torch.uint8, device=d)
                     for d in self.mesh.devices]

    def clear(self) -> None:
        from ..dist import sharded

        self.tables = sharded.sharded_clear(self.tables)

    def shrink(self, min_count: int, max_count: int) -> None:
        from ..dist import sharded

        self._rebuild(self.cap_local, min_count, max_count)
        self.tot = sharded.sharded_nfull_stats(self.mesh, self.tables)[1]

    def hist(self) -> np.ndarray:
        from ..dist import sharded

        return sharded.sharded_table_hist(self.mesh, self.tables,
                                          YAK_N_COUNTS)


class MeshSortYakEngine:
    """The two-pass yak engine on the mesh (yak.py:774-922).

    Pass 1 routes each step's k-mers to their owners
    (dist.sharded.ShardedSortEngine.route_batch) and hands them to the
    deferred admission (pipeline.yak_admit.ShardedDeferredYak), which
    resolves at the end of the pass which keys the bloom admits and the
    per-step `[M` totals; with bf_shift == 0 there is no pass 2
    (yak_count_file), so pass 1 also counts.  Pass 2 counts file 2 in
    the same sharded engine; `shrink` joins each shard's admitted pass-1
    keys against its pass-2 counts (`_shrink_join_core`) and sums.

    The bloom is partitioned by owner (BloomSpec.owner_bits): probe
    values equal the single-device ones, and keys sharing a bit share an
    owner, so the admitted keys and the histogram equal SortYakEngine's;
    the `[M` lines follow the mesh's own steps.  `devices` and
    `plain_kernels` as MeshSortCountEngine's."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, log=None, devices=None,
                 plain_kernels: bool = False):
        from ..dist import sharded
        from .yak_admit import ShardedDeferredYak

        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.log = log
        self.mesh = sharded.make_mesh(devices)
        self.n_dev = self.mesh.size
        self.device = self.mesh.devices[0]
        self.owner_bits = self.n_dev.bit_length() - 1
        self.plain_kernels = plain_kernels
        self.row_bases = max(int(chunk_size) // self.n_dev, 1 << 16)
        self.capacity_block = self.row_bases + 4096
        self._route = sharded.ShardedSortEngine(self.mesh, k,
                                                plain_kernels=plain_kernels)
        bloom_wanted = (bf_n_hash > 0 and bf_shift > pre
                        and (bf_shift - pre) >= BLK_SHIFT)
        self.use_bloom = (bloom_wanted and pre >= self.owner_bits
                          and _bloom_geometry_ok(bf_shift, pre,
                                                 self.owner_bits))
        if bloom_wanted and not self.use_bloom:
            # the per-shard bloom partition needs at least one prefix bit
            # per owner; with fewer, pass 1 admits every key
            warn("yak_count",
                 f"-p{pre} has fewer prefix bits than the {self.n_dev}"
                 f"-device mesh needs ({self.owner_bits}); bloom "
                 "prefilter disabled (two-file admission differs from "
                 "a single-chip run)")
        if self.use_bloom:
            self.bf_shift = _clamp_bf_shift(bf_shift, self.owner_bits)
            self.spec = BloomSpec(pre, self.bf_shift, bf_n_hash,
                                  self.owner_bits)
        else:
            self.spec = None
        budget = int(os.environ.get("KMER_TPU_TAP_BUDGET", str(1 << 30)))
        self.adm = ShardedDeferredYak(self.mesh, self.spec, self.use_bloom,
                                      budget_bytes=budget,
                                      plain_kernels=plain_kernels)
        self.tot = 0
        self._k1 = None  # admitted pass-1 keys, one tensor a shard
        self._hist = None  # post-shrink histogram (host)
        self.stats = []

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        """One pass; pass 1's `[M` lines come when it ends (deferred),
        pass 2's live, each repeating the pass-1 total."""
        st = IngestStats()
        self.stats.append(st)
        t_loop = time.perf_counter()
        if create_new:
            # pass-1 counts are observable only when no pass 2 follows
            keep_counts = not self.bf_shift > 0
            seqs = []
            for rows, rb, n_seqs in _mesh_row_batches(self, paths, st):
                t1 = time.perf_counter()
                owned = self._route.route_batch(rows, row_bytes=rb)
                self.adm.add_chunk(owned, step_end=True)
                if keep_counts:
                    self._route.add_chunk_planes(owned)
                seqs.append(n_seqs)
                st.dispatch_s += time.perf_counter() - t1
            self._k1, per_step, self.tot = self.adm.finish()
            if self.log is not None:
                running = 0
                for n_seqs, new in zip(seqs, per_step):
                    running += int(new)
                    self.log(n_seqs, running)
        else:
            for rows, rb, n_seqs in _mesh_row_batches(self, paths, st):
                t1 = time.perf_counter()
                self._route.add_batch(rows, row_bytes=rb)
                st.dispatch_s += time.perf_counter() - t1
                if self.log is not None:
                    self.log(n_seqs, self.tot)
        st.loop_s = time.perf_counter() - t_loop

    def destroy_bloom(self) -> None:
        pass  # no bits array: admission was resolved when pass 1 ended

    def clear(self) -> None:
        # pass-2 counts go to the emptied sharded engine; the admitted
        # pass-1 keys stay in _k1
        self._route.reset()

    def shrink(self, min_count: int, max_count: int) -> None:
        """Each shard's join of its admitted pass-1 keys against its
        pass-2 counts (yak.py:928-997), histograms and totals summed; an
        empty shard's pass 2 counts 0 for each of its keys."""
        self._route.compact()
        hist, tot = np.zeros(YAK_N_COUNTS, np.int64), 0
        for keys1, comp in zip(self._k1, self._route.shards):
            keys2, c2 = comp.runs[0] if comp.runs else (
                keys1[:0], torch.zeros(0, dtype=torch.int32,
                                       device=keys1.device))
            h, t = _shrink_join_core(keys1, keys2, c2, min_count, max_count)
            hist += h.cpu().numpy()
            tot += int(t)
        both = self._route._sum_procs(np.append(hist, tot))
        hist, tot = both[:-1], int(both[-1])
        hist[0] = 0  # bin 0 counts the dropped lanes
        self._hist, self.tot = hist, tot

    def hist(self) -> np.ndarray:
        if self._hist is not None:
            return self._hist
        # bf_shift == 0: the exact counts pass 1 accumulated
        return self._route.hist(YAK_N_COUNTS, max_count=YAK_MAX_COUNT)


def make_yak_engine(**kw):
    """The two-file engine (yak.py:1117-1131): the sort-based engines by
    default, MeshSortYakEngine in a run of several processes or when the
    tools count on the mesh (pipeline.counter.use_mesh), else
    SortYakEngine; KMER_TPU_TABLE_YAK=1 takes the open-addressing table
    engines instead, MeshYakEngine and YakEngine."""
    from ..dist.sharded import process_count

    table = os.environ.get("KMER_TPU_TABLE_YAK", "") == "1"
    if process_count() > 1 or use_mesh():
        return MeshYakEngine(**kw) if table else MeshSortYakEngine(**kw)
    return YakEngine(**kw) if table else SortYakEngine(**kw)


def yak_count_file(fn1: str, fn2: Optional[str], opt: SortYakEngine
                   ) -> SortYakEngine:
    """The yak_count_file flow (yak-count.c:453-464, yak.py:1134-1144):
    the second pass and the shrink run when -b is above 0, whether or
    not the bloom's geometry enabled it."""
    opt.count([fn1], create_new=True)
    if opt.bf_shift > 0:
        opt.destroy_bloom()
        opt.clear()
        opt.count([fn2 if fn2 else fn1], create_new=False)
        opt.shrink(2, YAK_MAX_COUNT)
    return opt
