"""Sharded k-mer counting over a mesh of devices (port of
kmer_tpu/dist/sharded.py: `make_mesh`, the sort-based routing,
`ShardedSortEngine`, the mesh form of `counts_for`, and the
open-addressing tables a shard of the table engines).

Every valid k-mer has exactly one owner, the shard whose index is the
key's low bits, `key & (n_shards - 1)` (the hash-prefix routing of the
reference's kc-c4, kmer_tpu/dist/sharded.py:304).  Each shard counts its
own keys in a `KmerCompactor` (table/compactor.py: stream ladder, budget
trips, the merge-path and segment-histogram kernels, one-plane keys at
k <= 15), so histograms, distinct totals and `counts_for` answers are
sums over the shards, as the JAX package's `psum`s are.

  route        one stable sort of a row's keys by owner, split by the
               owners' counts: ragged buckets, each in stream order.
  all_to_all   owner j receives the concatenation of every source row's
               bucket j, in source order; so each owner sees the global
               stream order restricted to its keys, which the mesh
               yak-count's admission depends on (pipeline/yak_admit.py
               `ShardedDeferredYak`).

The JAX package gives every destination a fixed window of lanes a step,
pads it with sentinels and replays a batch with doubled windows when one
overflows: static shapes for XLA.  The buckets here are ragged, so there
are no windows, no padding and no replay, and one owner may take every
lane (k = 32, where every key is hash64(0)).

A `Mesh` is an ordered list of torch devices with the JAX package's
("data", "shard") factorization; shard index = data * S + shard.  One
device may appear more than once: the tests run eight CPU entries, as
the JAX suite runs eight virtual CPU devices, and a single card can hold
several logical shards.

Several processes (torch.distributed, dist/multihost.py) make one mesh
of every process's shards, process-major as JAX orders `jax.devices()`:
process p holds global shards p * n_local .. (p + 1) * n_local - 1, and
`all_to_all` crosses processes with one ragged `all_to_all_single`.
The factorization and the owners are those of the global shard count.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..kernels import extract
from ..kernels.keys import SENT, from_hi_lo, to_hi_lo
from ..table import count_table as ct
from ..table.compactor import KmerCompactor
from ..utils import trace


# each shard's stream-ladder run quantum and smallest padded run
# (sharded.py:410-413: a device owns 1/n_dev of the lanes, so its runs
# are smaller than the single-device compactor's 2^24 / 2^16)
_MESH_STREAM_CHUNK = 1 << 22
_MESH_STREAM_MIN = 1 << 12


# -- processes -------------------------------------------------------------

def process_index() -> int:
    """This process's rank, 0 unless torch.distributed is initialized."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size, 1 unless torch.distributed is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_device() -> torch.device:
    """Where a collective's tensors live: the process's card under
    NCCL, the CPU under gloo (whose collectives take host tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_ints(values) -> np.ndarray:
    """Every process's int64 vector (the same length everywhere),
    stacked in rank order: (process_count, len).  A collective."""
    t = torch.as_tensor(np.asarray(values, np.int64).ravel()).to(
        collective_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allreduce_ints(values, op: str = "sum") -> np.ndarray:
    """The elementwise sum (or "max") of an int64 vector over the
    processes.  A collective."""
    t = torch.as_tensor(np.asarray(values, np.int64).ravel()).to(
        collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return t.cpu().numpy()


class Mesh:
    """This process's devices in shard order, factored with the rest of
    the processes' as (data, shard) (JAX's `Mesh(devices.reshape(data,
    shard), ("data", "shard"))`): `size` counts the shards of every
    process, `devices` those of this one, which are global shards
    `first` .. `first` + len(devices) - 1."""

    def __init__(self, devices: Sequence, data: int, shard: int,
                 n_proc: int = 1, pid: int = 0):
        self.devices = [torch.device(d) for d in devices]
        assert data * shard == len(self.devices) * n_proc
        self.shape = {"data": data, "shard": shard}
        self.n_proc, self.pid = n_proc, pid
        self.first = pid * len(self.devices)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["shard"]


def local_rank() -> int:
    """LOCAL_RANK (torchrun's name), else the rank: a process's index
    among those on its host."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def default_devices() -> List[torch.device]:
    """The mesh's devices when none are given (the device rule of
    kmer_tpu_torch.default_device): the one CPU device under
    KMER_TPU_PLATFORM=cpu; in a run of several processes, this process's
    card, cuda:(LOCAL_RANK % cards), never every visible one; else
    every visible CUDA device."""
    dev = default_device()
    if dev.type != "cuda":
        return [dev]
    n = torch.cuda.device_count()
    if process_count() > 1:
        return [torch.device("cuda", local_rank() % n)]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, data: Optional[int] = None,
              shard: Optional[int] = None) -> Mesh:
    """A ("data", "shard") mesh (sharded.py:56-69) of `devices` (this
    process's) and every other process's as many; without sizes, the
    most square factorization of the global shard count."""
    devices = default_devices() if devices is None else list(devices)
    n_proc = process_count()
    n = len(devices) * n_proc
    if data is None or shard is None:
        for s in range(math.isqrt(n), 0, -1):
            if n % s == 0:
                data, shard = s, n // s
                break
    return Mesh(devices, data, shard, n_proc, process_index())


def _owner_sort(keys: torch.Tensor, n_dest: int):
    """(keys stably sorted by owner with the invalid lanes last, lanes
    per owner as a tensor of n_dest counts)."""
    # a 16-bit sort key: a radix sort then makes 2 passes, not 8
    assert n_dest < 1 << 15
    dest = torch.where(keys != SENT, keys & (n_dest - 1),
                       n_dest).to(torch.int16)
    s_dest, order = torch.sort(dest, stable=True)
    # each owner's bounds by binary search on the sorted owners, as
    # sharded.py:207-210 finds them
    bounds = torch.searchsorted(s_dest, torch.arange(
        n_dest + 1, dtype=torch.int16, device=keys.device))
    return keys[order], torch.diff(bounds)


def _split(sorted_keys: torch.Tensor, counts: List[int]) -> List[torch.Tensor]:
    return list(torch.split(sorted_keys[:sum(counts)], counts))


def route_rows(rows: Sequence[torch.Tensor], n_dest: int
               ) -> List[List[torch.Tensor]]:
    """`route` of each row; every row's owner sort is queued before the
    first read of the owners' counts."""
    routed = [_owner_sort(keys, n_dest) for keys in rows]
    return [_split(s, c.tolist()) for s, c in routed]


def route(keys: torch.Tensor, n_dest: int) -> List[torch.Tensor]:
    """The owner buckets of one row's sentinelized keys (the counterpart
    of `_bucketize_by_sort`, sharded.py:173-226): bucket j holds the
    valid keys with key & (n_dest - 1) == j, in stream order (the sort is
    stable on the owner alone; do not add the key to it).  On the biased
    int64 layout the low bits are the JAX package's lo-plane bits."""
    return route_rows([keys], n_dest)[0]


def all_to_all(send: Sequence[Sequence[torch.Tensor]], mesh: Mesh
               ) -> List[torch.Tensor]:
    """Owner j receives cat(send[i][j] for each source i in order), on
    mesh.devices[j]: the tiled, source-ordered all_to_all of
    sharded.py:309-314 with ragged buckets.  `send` holds this process's
    rows, each with a bucket for every global owner; the result holds
    this process's owners, and with several processes the sources are
    every process's rows, process-major (`_exchange`)."""
    if mesh.n_proc > 1:
        return _exchange(send, mesh)
    return [torch.cat([row[j].to(dev, non_blocking=True) for row in send])
            for j, dev in enumerate(mesh.devices)]


def _exchange(send, mesh: Mesh) -> List[torch.Tensor]:
    """all_to_all across processes.  One all-gather of the lane counts
    (source row x global owner, rows past this process's padded with 0),
    then one ragged `all_to_all_single`: the buffer for process q holds
    q's owners in order, each with this process's rows in order, so what
    arrives from process p splits into one piece an owner, and owner j
    is the concatenation of its pieces in process order.  Under gloo the
    buffers go through pinned host memory; under NCCL they stay on the
    card.  A `mesh.exchange` span (utils/trace.py) whose `bytes` are
    those sent and received."""
    with trace.span("mesh.exchange") as sp:
        out, nbytes = _exchange_lanes(send, mesh)
        sp.set(bytes=nbytes)
    return out


def _exchange_lanes(send, mesh: Mesh):
    n_proc, n_loc = mesh.n_proc, len(mesh.devices)
    counts = np.zeros((n_loc, mesh.size), np.int64)
    for i, row in enumerate(send):
        counts[i] = [b.shape[0] for b in row]
    allc = allgather_ints(counts).reshape(n_proc, n_loc, n_proc, n_loc)
    dev = collective_device()
    pieces = [row[q * n_loc + j] for q in range(n_proc)
              for j in range(n_loc) for row in send]
    staged = dev.type == "cpu" and any(d.type == "cuda"
                                       for d in mesh.devices)
    if pieces and not staged:
        buf = torch.cat([p.to(dev) for p in pieces])
    elif pieces:
        card = torch.cat([p.to(mesh.devices[0]) for p in pieces])
        buf = torch.empty(card.shape, dtype=torch.int64, pin_memory=True)
        buf.copy_(card)
    else:
        buf = torch.empty(0, dtype=torch.int64, device=dev)
    in_splits = counts.reshape(n_loc, n_proc, n_loc).sum(axis=(0, 2))
    # (source process, my owner) lanes
    mine = allc[:, :, mesh.pid, :].sum(axis=1)
    recv = torch.empty(int(mine.sum()), dtype=torch.int64, device=dev,
                       pin_memory=staged)
    dist.all_to_all_single(recv, buf, mine.sum(axis=1).tolist(),
                           in_splits.tolist())
    parts = torch.split(recv, mine.ravel().tolist())
    out = [torch.cat([parts[p * n_loc + j].to(d, non_blocking=True)
                      for p in range(n_proc)])
           for j, d in enumerate(mesh.devices)]
    return out, 8 * (int(buf.shape[0]) + int(recv.shape[0]))


class ShardedSortEngine:
    """The sort-based counter on a mesh (sharded.py:462-849): each batch
    holds up to one row per shard; row i is extracted on shard i's
    device, routed, exchanged, and every shard's owned keys go into its
    own compactor.

    budget_bytes applies per shard, as the JAX package's per-device run
    bytes do (sharded.py:608-610); when a trip fires changes no count.
    `plain_kernels=True` makes every shard (and the extraction) call the
    kernels' plain PyTorch versions, as SortCountEngine's switch does."""

    def __init__(self, mesh: Mesh, k: int, budget_bytes: int = 2 << 30,
                 plain_kernels: bool = False):
        self.mesh = mesh
        self.k = k
        self.n_dev = mesh.size
        # low-bit routing and the per-shard bloom partition
        # (BloomSpec.owner_bits) both need a power-of-two shard count
        if self.n_dev & (self.n_dev - 1):
            raise ValueError(f"mesh must have a power-of-two device count, "
                             f"got {self.n_dev}")
        self.budget_bytes = budget_bytes
        self.plain_kernels = plain_kernels
        self._extract = (extract.extract_keys_plain if plain_kernels
                         else extract.extract_keys)
        self._extract_rows = (extract.extract_keys_rows_plain
                              if plain_kernels else extract.extract_keys_rows)
        self.reset()

    def reset(self) -> None:
        """Drop all counts (new, empty shard compactors)."""
        self.shards = [
            KmerCompactor(dev, budget_bytes=self.budget_bytes,
                          key_bits=2 * self.k,
                          plain_kernels=self.plain_kernels,
                          stream_chunk=_MESH_STREAM_CHUNK,
                          stream_min=_MESH_STREAM_MIN)
            for dev in self.mesh.devices]
        self.total_kmers = 0

    @property
    def total_kmers(self) -> int:
        """Valid k-mer windows of every row so far (the per-row counts
        stay on their devices until asked for)."""
        if self._nk_dev:
            self._nk_host += sum(int(n) for n in self._nk_dev)
            self._nk_dev.clear()
        return self._nk_host

    @total_kmers.setter
    def total_kmers(self, v: int) -> None:
        self._nk_dev = []
        self._nk_host = int(v)

    def route_batch(self, rows, row_bytes: Optional[int] = None, aux=None,
                    ingest: str = "ascii") -> List[torch.Tensor]:
        """Extract and route one batch without counting it: each shard's
        owned keys, on its device.  `rows[i]` (ASCII bytes, or 2-bit codes
        under ingest "packed" / "packed_structural" with `aux[i]` the
        mask / used-byte count, as pipeline.counter.extract_row takes
        them) goes to shard i; a batch may hold fewer rows than shards.
        `row_bytes` slices uniform reads when it exceeds k
        (sharded.py:292-298)."""
        from ..pipeline.counter import extract_row

        rb = row_bytes if row_bytes and row_bytes > self.k else None
        if ingest == "packed_structural" and rb is None:
            raise ValueError("structural packed ingest needs row_bytes")
        assert len(rows) <= len(self.mesh.devices), "more rows than shards"
        keys = []
        for i, row in enumerate(rows):
            dev = self.mesh.devices[i]
            a = aux[i] if aux is not None else None
            if isinstance(a, torch.Tensor):
                a = a.to(dev, non_blocking=True)
            row_keys, n_valid = extract_row(
                row.to(dev, non_blocking=True), self.k, rb, a, ingest,
                self._extract, self._extract_rows)
            self._nk_dev.append(n_valid)
            keys.append(row_keys)
        return all_to_all(route_rows(keys, self.n_dev), self.mesh)

    def add_chunk_planes(self, owned: Sequence[torch.Tensor]) -> None:
        """Count already-routed owned keys (route_batch's output): the
        mesh yak engine's pass 1 routes once and counts too."""
        for comp, keys in zip(self.shards, owned):
            if keys.shape[0]:
                comp.add_raw(keys)

    def add_batch(self, rows, row_bytes: Optional[int] = None, aux=None,
                  ingest: str = "ascii") -> None:
        self.add_chunk_planes(self.route_batch(rows, row_bytes, aux, ingest))

    def compact(self) -> None:
        for comp in self.shards:
            comp.compact()

    def _sum_procs(self, v: np.ndarray) -> np.ndarray:
        """v summed over the processes (a collective) when there are
        several: the JAX package's psum over "data" and "shard"."""
        return allreduce_ints(v) if self.mesh.n_proc > 1 else v

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        """The histogram summed over the shards (keys are uniquely owned,
        sharded.py:356-357); _n_distinct is their distinct total, 0 with
        no input."""
        h = np.zeros(n_bins + 1, np.int64)
        for comp in self.shards:
            hs, nds = comp.hist(n_bins, max_count, min_keep)
            h[:n_bins] += hs
            h[n_bins] += nds
        h = self._sum_procs(h)
        self._n_distinct = int(h[n_bins])
        return h[:n_bins]

    def counts_for(self, query_hi, query_lo) -> np.ndarray:
        """Total multiplicity of each query key, in query order: the sum
        of the shards' answers, of which only the owner's can be nonzero
        (sharded_counts_for_fn, sharded.py:852-876).  With several
        processes every one must ask the same queries."""
        out = np.zeros(len(query_hi), np.int64)
        for comp in self.shards:
            out += comp.counts_for(query_hi, query_lo)
        return self._sum_procs(out)

    def save_checkpoint(self, path: str) -> None:
        """Every shard compacted to (key, count) runs, written in the JAX
        package's layout (sharded.py:743-764): uint32 hi / lo / cnt of
        shape (data, shard, L), sentinel keys with count 0 past each
        shard's run, L the largest run rounded up to JAX's size class
        (:735; 1 when every shard is empty), meta = [k, total_kmers,
        total_dropped = 0].  Written to a temporary file and renamed.
        One process only: dist.multihost writes a file a process."""
        if self.mesh.n_proc > 1:
            raise ValueError("a mesh of several processes saves through "
                             "dist.multihost.MultihostSortEngine")
        self.compact()
        runs = [comp.runs[0] if comp.runs else None for comp in self.shards]
        n_max = max((int(r[0].shape[0]) for r in runs if r is not None),
                    default=0)
        size = (max(1 << 16, 1 << max(n_max - 1, 1).bit_length())
                if n_max else 1)
        d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
        hi = np.full((d, s, size), 0xFFFFFFFF, np.uint32)
        lo = hi.copy()
        cnt = np.zeros((d, s, size), np.uint32)
        for j, run in enumerate(runs):
            if run is None:
                continue
            keys, counts = run
            n, (a, b) = int(keys.shape[0]), divmod(j, s)
            hi[a, b, :n], lo[a, b, :n] = to_hi_lo(keys)
            cnt[a, b, :n] = counts.cpu().numpy().view(np.uint32)
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp, hi=hi, lo=lo, cnt=cnt,
            meta=np.asarray([self.k, self.total_kmers, 0], np.int64))
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint that either package wrote on a mesh of the
        same shape (keys stay with their owners); the sentinel padding is
        dropped."""
        z = np.load(path)
        d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
        if int(z["meta"][0]) != self.k:
            raise ValueError(f"checkpoint k {int(z['meta'][0])} != {self.k}")
        if z["hi"].shape[:2] != (d, s):
            raise ValueError(f"checkpoint mesh shape {z['hi'].shape[:2]} != "
                             f"{(d, s)}")
        self.reset()
        for j, comp in enumerate(self.shards):
            hi, lo, cnt = (z[name][divmod(j, s)] for name in ("hi", "lo",
                                                            "cnt"))
            real = ~((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF))
            if real.any():
                comp.add_counted(
                    from_hi_lo(hi[real], lo[real], comp.device),
                    torch.from_numpy(np.ascontiguousarray(
                        cnt[real]).view(np.int32)).to(comp.device))
        self.total_kmers = int(z["meta"][1])


# -- the open-addressing tables, one a shard (sharded.py:100-171, 881-1041)
#
# One CountTable (table/count_table.py) on each of this process's shard
# devices, all of one capacity.  The JAX package holds them as
# (data, shard, cap) planes under shard_map and sums or maximizes with
# psum / pmax; here they are a list, and across processes the sums and
# maxima go through allreduce_ints (a collective: every process calls
# these in step).  A shard's lane plane is its owner bucket from
# `route_batch`: ragged, valid keys only, in global stream order, where
# JAX's is n_dev sentinel-padded windows.  The lane order, and so every
# slot, is the same; only the tag's stride m (the plane's length)
# differs, which changes a winner only once round * m passes 2^32.

def make_sharded_tables(mesh: Mesh, cap_local: int) -> List[ct.CountTable]:
    return [ct.make(cap_local, dev) for dev in mesh.devices]


def _reduce(mesh: Mesh, values, op: str) -> int:
    """The sum (or "max") over the shards of every process of one int a
    shard, `values` holding this process's."""
    local = max(values, default=0) if op == "max" else sum(values)
    return int(allreduce_ints([local], op)[0]) if mesh.n_proc > 1 \
        else int(local)


def sharded_yak_ingest(mesh: Mesh, tables, bits, owned, spec,
                       create_new: bool, use_bloom: bool,
                       exact_bloom: bool = False,
                       plain_kernels: bool = False):
    """Each shard's bloom gate and table insert over its owned keys
    (sharded_yak_ingest_fn, sharded.py:897-953): a shard holds the bloom
    bits and the slots of the keys it owns (BloomSpec.owner_bits), so
    each is shard-local, and its lanes in stream order make the
    sequential bloom exact.  Returns (tables, bits, n_new summed, n_dead
    of the worst shard: growth must relieve its chains)."""
    from ..pipeline.yak import _yak_ingest_core

    out_t, out_b, n_new, n_dead = [], [], [], []
    for table, b, keys in zip(tables, bits, owned):
        t, b, nn, nd = _yak_ingest_core(table, b, keys, spec, create_new,
                                        use_bloom, exact_bloom, plain_kernels)
        out_t.append(t)
        out_b.append(b)
        n_new.append(int(nn))
        n_dead.append(int(nd))
    return (out_t, out_b, _reduce(mesh, n_new, "sum"),
            _reduce(mesh, n_dead, "max"))


def sharded_clear(tables) -> List[ct.CountTable]:
    """Every shard's counts zeroed (sharded_clear_fn, yak_ch_clear)."""
    return [ct.clear_counts(t) for t in tables]


def sharded_rebuild(tables, new_capacity: int, min_count: int = 0,
                    max_count=None, plain_kernels: bool = False
                    ) -> List[ct.CountTable]:
    """Every shard rebuilt into new_capacity slots keeping counts in
    [min_count, max_count] (sharded_rebuild_fn: the growth rehash, and
    yak_ch_shrink)."""
    return [ct.rebuild(t, new_capacity, min_count, max_count, plain_kernels)
            for t in tables]


def sharded_valid_max(mesh: Mesh, owned) -> int:
    """The most lanes any shard owns in a routed step (every one valid):
    the headroom each table needs before the insert
    (sharded_chunk_valid_max_fn)."""
    return _reduce(mesh, [k.shape[0] for k in owned], "max")


def sharded_nfull_stats(mesh: Mesh, tables):
    """(max, sum) of the shards' FULL slots (sharded_nfull_stats_fn): the
    growth input and the distinct total after the shrink."""
    nf = [int(t.n_full) for t in tables]
    return _reduce(mesh, nf, "max"), _reduce(mesh, nf, "sum")


def sharded_table_hist(mesh: Mesh, tables, n_bins: int) -> np.ndarray:
    """The count histogram summed over the shards (sharded_hist_fn):
    keys are uniquely owned, so the sum is the histogram."""
    h = np.zeros(n_bins, np.int64)
    for t in tables:
        h += ct.hist(t, n_bins).cpu().numpy()
    return allreduce_ints(h) if mesh.n_proc > 1 else h


def sharded_count_step(router: ShardedSortEngine, tables, rows,
                       max_count: Optional[int], row_bytes=None,
                       plain_kernels: bool = False):
    """The table-based kc step (sharded_count_step_fn, sharded.py:
    100-153): extract each row on its shard, route the keys to their
    owners (`router.route_batch`) and insert each shard's into its
    table.  Returns (tables, n_new summed, n_dropped = 0: the buckets
    are ragged, no window overflows).  The caller sizes the tables."""
    owned = router.route_batch(rows, row_bytes=row_bytes)
    out, n_new = [], []
    for table, keys in zip(tables, owned):
        valid = torch.ones(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
        t, nn = ct.insert(table, keys, valid, max_count,
                          plain_kernels=plain_kernels)
        out.append(t)
        n_new.append(int(nn))
    return out, _reduce(router.mesh, n_new, "sum"), 0
