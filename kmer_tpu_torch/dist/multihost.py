"""Runs of several processes (port of kmer_tpu/dist/multihost.py):
torch.distributed init, per-process input sharding, the single-reader
broadcast, and the cross-process loop of the sharded sort engine.

Each process holds its own shards of one global mesh (dist/sharded.py,
process-major: process p's shards are global shards p * n_local ..),
reads its own files (round-robin) and exchanges keys with the others
(`sharded.all_to_all`, one ragged `all_to_all_single` a step).  Every
process must call every collective in the same order, but file shards
drain at different rates, so each step first agrees (one small
all-gather) whether any process still has data; an exhausted process
sends no rows and still receives its owners' keys.  Histograms,
distinct totals and `counts_for` answers are all-reduced sums; the tools
print from process 0 only (utils.log.is_primary).

Backend: NCCL when the process's shards are on a card that no other
process of the host shares; gloo otherwise (the CPU, or several
processes on one card, which NCCL refuses).  Under gloo the exchange
goes through pinned host memory.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..kernels.keys import from_hi_lo, to_hi_lo
from ..pipeline.counter import IngestStats, _iter_packed, _staged_items
from . import sharded
from .sharded import (allgather_ints, allreduce_ints, collective_device,
                      process_count, process_index)


def choose_backend(device_type: str, procs_on_host: int, n_cards: int
                   ) -> str:
    """NCCL when each process of the host has a card of its own, gloo on
    the CPU or when processes share a card."""
    if device_type == "cuda" and procs_on_host <= n_cards:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group at tcp://<address> with the
    world size and the rank given, or read from torch's own names
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK; torchrun sets them).
    Call before any other use of the port in every process; a single
    process needs no init.  The process's card is cuda:(LOCAL_RANK %
    cards) (LOCAL_RANK defaults to the rank) and becomes the current
    one; the backend follows from the topology (`choose_backend`, the
    processes on the host from LOCAL_WORLD_SIZE, else all of them), and
    a failure of it is raised."""
    if num_processes in (None, 1) and coordinator_address is None \
            and os.environ.get("WORLD_SIZE", "1") == "1":
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    dev = default_device()
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % n_cards)
        backend = choose_backend(
            "cuda", int(env.get("LOCAL_WORLD_SIZE", world)), n_cards)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def shard_files(paths: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Round-robin file assignment for this process (:47-53)."""
    pi = sharded.process_index() if process_index is None else process_index
    pc = sharded.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


def single_reader() -> bool:
    """KMER_TPU_SINGLE_READER=1 (true, on, yes): process 0 reads every
    file and broadcasts each global batch, instead of per-process file
    sharding.  Batch composition, and with it yak-count's per-batch `[M`
    totals and bloom admission order, then matches a 1-process run of
    the same mesh; ingest is bounded by one reader and the broadcast."""
    return os.environ.get("KMER_TPU_SINGLE_READER", "").strip().lower() \
        in ("1", "true", "on", "yes")


def _local_batches(paths: Sequence[str], k: int, block: int,
                   n_local_rows: int, qual_policy=None,
                   capacity: Optional[int] = None):
    """Pack this process's files into (n_local_rows, width) uint8
    batches (width = capacity or block; a short last group padded with
    zero rows, zero bytes being invalid bases); yields (rows, n_bases,
    n_seqs, row_bytes_if_uniform)."""
    width = capacity or block
    rows, rbs, nb, ns = [], [], 0, 0
    for buf, b_nb, b_ns, rb, _be in _iter_packed(paths, k, block, width,
                                                 qual_policy):
        rows.append(buf if buf.shape[0] == width
                    else np.pad(buf, (0, width - buf.shape[0])))
        rbs.append(rb)
        nb += int(b_nb)
        ns += int(b_ns)
        if len(rows) == n_local_rows:
            yield (np.stack(rows), nb, ns,
                   rbs[0] if len(set(rbs)) == 1 else None)
            rows, rbs, nb, ns = [], [], 0, 0
    if rows:
        pad = [np.zeros(width, np.uint8)] * (n_local_rows - len(rows))
        yield (np.stack(rows + pad), nb, ns,
               rbs[0] if len(set(rbs)) == 1 else None)


def _bcast_batches(paths: Sequence[str], k: int, block: int, n_rows: int,
                   qual_policy=None, capacity: Optional[int] = None):
    """Single-reader iterator (:67-105): process 0 packs GLOBAL (n_rows,
    width) batches over all files; a 4-int64 header, then the rows, go
    to every process by broadcast, and every process yields the same
    (rows, n_bases, n_seqs, row_bytes), rows a tensor on the collective
    device.  Every step is a collective, so it runs on the calling
    thread with no prefetch.  `capacity` (the row width, >= block) must
    be the comparison target's: buffers split where the packer runs out
    of room, not at the batch rule."""
    pid = process_index()
    dev = collective_device()
    width = capacity or block
    it = (_local_batches(paths, k, block, n_rows, qual_policy, capacity)
          if pid == 0 else None)
    while True:
        item = next(it, None) if pid == 0 else None
        hdr = torch.tensor(
            [0, 0, 0, -1] if item is None else
            [1, item[1], item[2], item[3] if item[3] else -1],
            dtype=torch.int64).to(dev)
        dist.broadcast(hdr, 0)
        has, nb, ns, rb = hdr.tolist()
        if has == 0:
            return
        rows = (torch.from_numpy(item[0]).to(dev) if pid == 0 else
                torch.empty((n_rows, width), dtype=torch.uint8, device=dev))
        dist.broadcast(rows, 0)
        yield rows, nb, ns, rb if rb > 0 else None


def process_steps(paths: Sequence[str], k: int, block: int, mesh,
                  qual_policy, pin: bool, prefetch: bool, st: IngestStats,
                  capacity: Optional[int] = None):
    """The steps of a run of several processes on `mesh`.  Yields (this
    process's rows, [] once it has none, row_bytes, and the step's
    n_bases and n_seqs summed over the processes).

    By default each process reads its own files (`shard_files`) in
    `_local_batches` of one row a shard, block wide, staged in the
    reader thread, and one all-gather a step of [has data, row_bytes or
    -1, n_bases, n_seqs] on the calling thread stops the run when no
    process has data and keeps row_bytes only when every process
    reports the same one (an exhausted process's -1 drops it for all,
    :191-209).  Under single_reader() the steps are `_bcast_batches`'
    global ones, `capacity` wide, and each process takes its shards'
    rows."""
    n_loc = len(mesh.devices)
    if single_reader() and mesh.n_proc > 1:
        for rows, nb, ns, rb in _bcast_batches(paths, k, block, mesh.size,
                                               qual_policy, capacity):
            yield list(rows[mesh.first: mesh.first + n_loc]), rb, nb, ns
        return
    it = _staged_items(
        _local_batches(shard_files(paths), k, block, n_loc, qual_policy),
        pin, prefetch, st)
    while True:
        item = next(it, None)
        rows, nb, ns, rb = item if item is not None else ([], 0, 0, None)
        if mesh.n_proc == 1:
            if item is None:
                return
            yield list(rows), rb, nb, ns
            continue
        got = allgather_ints([item is not None, rb or -1, nb, ns])
        if not got[:, 0].any():
            return
        rbs = got[:, 1]
        yield (list(rows), int(rbs[0]) if rbs[0] > 0 and (rbs == rbs[0]).all()
               else None, int(got[:, 2].sum()), int(got[:, 3].sum()))


class MultihostSortEngine:
    """The engines' interface (count_paths / hist / counts_for / totals /
    checkpoints) over every shard of every process (:133-360).  EVERY
    method is a collective: each process calls the same methods in the
    same order.  Under it is dist.sharded.ShardedSortEngine on this
    process's shards (`devices`, else sharded.default_devices(): one
    card a process); the global shard count must be a power of two.

    The JAX package's retry warning does not exist here: the ragged
    buckets never overflow (`lanes_per_dest` is gone with them)."""

    def __init__(self, k: int, block_bases: int = 10_000_000,
                 budget_bytes: int = 2 << 30, prefetch: bool = True,
                 qual_policy=None, devices=None,
                 plain_kernels: bool = False):
        self.k = k
        self.mesh = sharded.make_mesh(devices)
        self.n_dev = self.mesh.size
        self.n_local = len(self.mesh.devices)
        self.device = self.mesh.devices[0]
        self.row_bases = max(int(block_bases) // self.n_dev, 1 << 16)
        self.qual_policy = qual_policy
        self.prefetch = prefetch
        self.plain_kernels = plain_kernels
        self.eng = sharded.ShardedSortEngine(
            self.mesh, k, budget_bytes=budget_bytes,
            plain_kernels=plain_kernels)
        self.total_bases = 0  # GLOBAL totals (summed over the processes)
        self.total_seqs = 0
        self._kmers0 = 0  # a resumed checkpoint's global k-mer total
        self.stats = IngestStats()

    @property
    def total_kmers(self) -> int:
        """Valid k-mer windows of every process (a collective)."""
        local = self.eng.total_kmers
        if self.mesh.n_proc > 1:
            local = int(allreduce_ints([local])[0])
        return self._kmers0 + local

    def count_paths(self, paths: Sequence[str], progress=None) -> None:
        st = self.stats = IngestStats()
        t_loop = time.perf_counter()
        for rows, rb, nb, ns in process_steps(
                paths, self.k, self.row_bases, self.mesh, self.qual_policy,
                self.device.type == "cuda", self.prefetch, st):
            t1 = time.perf_counter()
            self.total_bases += nb
            self.total_seqs += ns
            self.eng.add_batch(rows, row_bytes=rb)
            st.dispatch_s += time.perf_counter() - t1
            if progress is not None:
                progress(self)
        st.loop_s = time.perf_counter() - t_loop

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h = self.eng.hist(n_bins, max_count, min_keep)
        self._n_distinct = self.eng._n_distinct
        return h

    def counts_for(self, query_hi, query_lo) -> np.ndarray:
        """Queries must be IDENTICAL on every process (each loads the
        same pattern file); the join is a collective."""
        return self.eng.counts_for(query_hi, query_lo)

    def _ckpt_file(self, path: str, pid=None, pc=None) -> str:
        pid = self.mesh.pid if pid is None else pid
        pc = self.mesh.n_proc if pc is None else pc
        return f"{path}.proc{pid}of{pc}.npz"

    def save_checkpoint(self, path: str) -> None:
        """One file a process, path.proc{pid}of{pc}.npz (:277-330), in
        the JAX package's layout: meta = [k, data, shard, pc, pid, size,
        total_kmers, total_dropped = 0, total_bases, total_seqs] (the
        totals global) and planes hi_/lo_/cnt_{di}_{si} of shape (1, 1,
        size) for this process's shards, (di, si) = divmod(global shard,
        shard), sentinel keys with count 0 past each run.  size is agreed
        by every process (the all-reduced largest run, rounded to JAX's
        size class; 1 with sentinel planes when no process has a key),
        since JAX resumes the files into one (data, shard, size) array.
        A collective; it ends with a barrier so that no process returns
        before every file is published."""
        self.eng.compact()
        runs = [comp.runs[0] if comp.runs else None
                for comp in self.eng.shards]
        n_max = max((int(r[0].shape[0]) for r in runs if r is not None),
                    default=0)
        if self.mesh.n_proc > 1:
            n_max = int(allreduce_ints([n_max], "max")[0])
        size = (max(1 << 16, 1 << max(n_max - 1, 1).bit_length())
                if n_max else 1)
        d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
        blocks = {}
        for j, run in enumerate(runs):
            di, si = divmod(self.mesh.first + j, s)
            hi = np.full((1, 1, size), 0xFFFFFFFF, np.uint32)
            lo = hi.copy()
            cnt = np.zeros((1, 1, size), np.uint32)
            if run is not None:
                keys, counts = run
                n = int(keys.shape[0])
                hi[0, 0, :n], lo[0, 0, :n] = to_hi_lo(keys)
                cnt[0, 0, :n] = counts.cpu().numpy().view(np.uint32)
            blocks.update({f"hi_{di}_{si}": hi, f"lo_{di}_{si}": lo,
                           f"cnt_{di}_{si}": cnt})
        meta = np.asarray(
            [self.k, d, s, self.mesh.n_proc, self.mesh.pid, size,
             self.total_kmers, 0, self.total_bases, self.total_seqs],
            np.int64)
        f = self._ckpt_file(path)
        tmp = f + ".tmp.npz"
        np.savez_compressed(tmp, meta=meta, **blocks)
        os.replace(tmp, f)
        if self.mesh.n_proc > 1:  # barrier: every file on disk
            allgather_ints([1])

    def resume_checkpoint_into(self, path: str) -> None:
        """Rebuild from this process's file of either package; k, the
        mesh shape and the process layout must match the saving run's
        (keys stay with their owners).  The sentinel padding is
        dropped."""
        pid, pc = self.mesh.pid, self.mesh.n_proc
        z = np.load(self._ckpt_file(path))
        k, d, s, zpc, zpid, _size, tk, _td, tb, ts = (
            int(x) for x in z["meta"])
        if k != self.k:
            raise ValueError(f"checkpoint k={k} != engine k={self.k}")
        if (d, s) != (self.mesh.shape["data"], self.mesh.shape["shard"]):
            raise ValueError(
                f"checkpoint mesh {d}x{s} != current "
                f"{self.mesh.shape['data']}x{self.mesh.shape['shard']}")
        if (zpc, zpid) != (pc, pid):
            raise ValueError(
                f"checkpoint written by process {zpid}/{zpc}, "
                f"loaded by {pid}/{pc}")
        self.eng.reset()
        for j, comp in enumerate(self.eng.shards):
            di, si = divmod(self.mesh.first + j, s)
            hi, lo, cnt = (z[f"{name}_{di}_{si}"].reshape(-1)
                           for name in ("hi", "lo", "cnt"))
            real = ~((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF))
            if real.any():
                comp.add_counted(
                    from_hi_lo(hi[real], lo[real], comp.device),
                    torch.from_numpy(np.ascontiguousarray(
                        cnt[real]).view(np.int32)).to(comp.device))
        self._kmers0 = tk
        self.total_bases, self.total_seqs = tb, ts


def count_multihost(paths: Sequence[str], k: int, block: int = 4_194_304,
                    n_bins: int = 256, max_count: Optional[int] = 1023,
                    min_keep: int = 1, queries=None, devices=None):
    """Count canonical k-mers over every shard of every process
    (:363-387).  Returns (hist, n_distinct), the same on every process,
    plus, when `queries` = (query_hi, query_lo) numpy arrays IDENTICAL
    on every process, those keys' counts.  Callers print from process 0
    only.  One process counts on its own shards."""
    n = len(devices if devices is not None else sharded.default_devices())
    eng = MultihostSortEngine(k, block_bases=block * n * process_count(),
                              devices=devices)
    eng.count_paths(paths)
    h = eng.hist(n_bins, max_count=max_count, min_keep=min_keep)
    if queries is not None:
        return h, eng._n_distinct, eng.counts_for(queries[0], queries[1])
    return h, eng._n_distinct
