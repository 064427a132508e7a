"""The end-to-end k-mer counting engines (port of
kmer_tpu/pipeline/counter.py): SortCountEngine on one device, and
MeshSortCountEngine on the single-process mesh (dist/sharded.py), which
`make_count_engine` picks under `use_mesh()`; in a run of several
processes it picks dist/multihost.py's MultihostSortEngine.

  reader thread:  the native C++ reader (io/native, a copy of the JAX
                  package's) decompresses, parses and packs reads into
                  flat ASCII blocks, one invalid byte between reads, or
                  under KMER_TPU_PACKED=1 into 2-bit base codes and an
                  invalid-slot bitmask (packed ingest); the same thread
                  stages each block in pinned host memory
  main thread:    copies the block to the device (non-blocking, from
                  pinned memory), unpacks a packed block to ASCII there,
                  extracts sentinelized keys with the extraction kernel
                  and appends them to the sort-based compactor
                  (table/compactor.py); on the mesh, the reader thread
                  groups one block a shard into a step, and each shard
                  extracts its block and routes the keys to their owners

The port imports nothing of kmer_tpu, so the JAX counter's host helpers
(_iter_packed, _iter_packed2, _trim_to_class, _prefetch, _timed_iter,
IngestStats) are ported here rather than imported.

Spans (utils/trace.py): a count loop is `count.loop` (`lanes_added`:
the lanes appended to the compactor); under it, in the
reader thread, `reader.block` (io/native) and `reader.stage` (`bytes`
staged), and in the main thread `ingest.wait` (blocked on the reader)
and `ingest.dispatch` (issuing the copy, extraction and compactor work),
whose times are IngestStats.wait_s and dispatch_s.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import default_device
from ..io import fastx, native, packing
from ..kernels import extract
from ..kernels.keys import from_hi_lo, to_hi_lo
from ..table.compactor import KmerCompactor
from ..utils import trace

# the open-addressing tables' load factor (counter.py:36): the yak table
# engines grow before a batch could push FULL + DELETED slots past it
GROW_LOAD = 0.65

# byte -> popcount (the mask-elision test without unpackbits' 8x blowup)
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


class IngestStats:
    """Per-stage wall accounting for one count_paths run.

    All fields are thread-seconds except loop_s (main-thread wall):
      reader_s    reader time (decompress + parse + pack, and the Python
                  side of each block), in the prefetch thread
      wait_s      main-thread time blocked on the reader
      dispatch_s  main-thread time dispatching device work, including
                  the stream throttle's waits (`compactor.throttle`
                  spans) and budget-trip compactions
                  (`compactor.compact`)
    Staging's time and bytes are the `reader.stage` spans'.
    """

    def __init__(self):
        self.reader_s = 0.0
        self.wait_s = 0.0
        self.dispatch_s = 0.0
        self.loop_s = 0.0


def _timed_iter(it, stats: IngestStats):
    """Accumulate producer-side time (runs inside the prefetch thread)."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            stats.reader_s += time.perf_counter() - t0
            return
        stats.reader_s += time.perf_counter() - t0
        yield item


def _trim_to_class(buf: np.ndarray, n: int) -> np.ndarray:
    """Trim a packed buffer to the smallest size class >= n bytes used.
    Bytes past n are zero (an invalid base), so trimming never changes
    the k-mer multiset; it keeps device work proportional to the input."""
    for cls in (1 << 16, 1 << 20, 1 << 23):
        if n <= cls < buf.shape[0]:
            return buf[:cls]
    return buf


def native_reader() -> bool:
    """Whether the native C++ reader (io/native) is usable; it builds
    with g++ at first use, and the pure-Python reader runs when it
    cannot."""
    return native.available()


def _iter_packed(
    paths: Sequence[str], k: int, block_bases: int, capacity: int,
    qual_policy=None, parent=trace.NULL,
) -> Iterator[Tuple[np.ndarray, int, int, Optional[int], bool]]:
    """Yield (ascii_u8[<=capacity], n_bases, n_seqs, row_bytes,
    batch_end), exactly as kmer_tpu/pipeline/counter.py:117-178:
    n_bases/n_seqs are true per-read totals, row_bytes is L+1 when every
    read in the buffer has length L, batch_end marks the end of one
    reference pipeline batch.  Uses the native C++ reader when it builds
    (its block calls are `reader.block` spans under `parent`), the
    pure-Python reader otherwise."""
    if all(p != "-" for p in paths) and native_reader():
        for buf, used, n_bases, n_seqs, rb, be in native.iter_packed_native(
            paths, k, block_bases, capacity, qual_policy, parent
        ):
            yield _trim_to_class(buf, used), n_bases, n_seqs, rb, be
        return
    max_len = capacity - 1
    step = max_len - (k - 1)
    for blk in fastx.read_blocks(paths, k, block_bases,
                                 qual_policy=qual_policy):
        # split over-long sequences into (k-1)-overlap chunks; consecutive
        # chunks tile the window sequence exactly once
        seqs = []
        for s in blk.seqs:
            if len(s) + 1 > capacity:
                for off in range(0, len(s) - (k - 1), step):
                    seqs.append(s[off : off + max_len])
            else:
                seqs.append(s)
        lens = {len(s) for s in seqs}
        rb = (lens.pop() + 1) if len(lens) == 1 else None
        # true totals ride the block's FIRST pack; continuation packs
        # report zero; the LAST pack of a block is a batch end
        n_seqs = sum(1 for s in blk.seqs if len(s) >= k)
        n_bases = blk.sum_len
        blk = fastx.Block(seqs, blk.sum_len, blk.n_kmers)
        packs = list(packing.pack_block(blk, capacity))
        for i, (buf, n) in enumerate(packs):
            yield (_trim_to_class(buf, n), n_bases, n_seqs, rb,
                   i == len(packs) - 1)
            n_seqs = n_bases = 0


def _use_packed_ingest(paths) -> bool:
    """2-bit packed host->device ingest (0.25-0.375 bytes a base instead
    of 1), as kmer_tpu/pipeline/counter.py:181-198 decides it: the JAX
    package turns it on by default only on a TPU backend, and the port
    has none, so here it runs only under KMER_TPU_PACKED=1 (or true, on,
    yes), on real files, through the native reader."""
    env = os.environ.get("KMER_TPU_PACKED", "").strip().lower()
    if env not in ("1", "true", "on", "yes"):
        return False
    if any(p == "-" for p in paths):
        return False
    return native_reader()


def _iter_packed2(paths, k: int, block_bases: int, capacity: int,
                  qual_policy=None, parent=trace.NULL):
    """Packed-ingest form of _iter_packed (kmer_tpu/pipeline/counter.py:
    201-231): yields (packed, mask, n_bytes_used, n_bases, n_seqs,
    row_bytes, batch_end) with the buffers trimmed to the smallest size
    class (slots past the packed region are mask-invalid, so trimming
    never changes the k-mer multiset).

    mask is None when it is purely structural: uniform rows with no
    N or other invalid base, so that every set bit is a row separator or
    the tail past n.  Any in-read invalid adds a bit and bits are never
    cleared, so the popcount decides it; the device rebuilds such a mask
    from (n, row_bytes) and the block moves 0.25 bytes a base."""
    for packed, mask, n, n_bases, n_seqs, rb, be in (
            native.iter_packed2bit_native(
                paths, k, block_bases, capacity, qual_policy, parent)):
        for cls in (1 << 16, 1 << 20, 1 << 23):
            if n <= cls < 4 * packed.shape[0]:
                packed, mask = packed[: cls // 4], mask[: cls // 8]
                break
        if rb and rb > k:
            slots = 8 * mask.shape[0]
            expected = (slots - n) + n // rb
            if int(_POPCNT8[mask].sum(dtype=np.int64)) == expected:
                mask = None
        yield packed, mask, n, n_bases, n_seqs, rb, be


def _prefetch(it, depth=2):
    """Run an iterator in a background thread.  Reader exceptions (e.g.
    unreadable input) re-raise in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def work():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded verbatim
            q.put((sentinel, e))
        finally:
            q.put(sentinel)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
            raise item[1]
        yield item


def _stage(item, pin: bool, parent=trace.NULL):
    """Wrap a reader item's arrays (the ASCII buffer, or the packed codes
    and the mask when there is one) as tensors; for a CUDA engine, copy
    them into pinned host memory (in the reader thread) so the
    host->device copies can run asynchronously.  A `reader.stage` span
    under `parent`, whose `bytes` are the arrays' bytes, the bytes
    kmer_tpu/pipeline/counter.py:265-277 counts as uploaded."""
    with trace.span("reader.stage", parent) as sp:
        nbytes, out = 0, []
        for x in item:
            if isinstance(x, np.ndarray):
                nbytes += x.nbytes
                x = torch.from_numpy(x)
                if pin:
                    x = x.pin_memory()
            out.append(x)
        sp.set(bytes=nbytes)
    return tuple(out)


def _extract_step_rows(ascii_u8: torch.Tensor, k: int, row_bytes: int,
                       fn=extract.extract_keys_rows):
    """Extraction (`fn`, as extract.extract_keys_rows) for uniform-length
    reads (kmer_tpu/pipeline/counter.py:473-487): every read occupies
    row_bytes = L+1 bytes, so only window ends at in-row offsets
    k-1..L-1 can be valid; the row-sliced plane holds just those lanes,
    written by the kernel in place of a slice and a copy of the flat
    plane, and the lanes invalid by layout never reach the sort."""
    return fn(ascii_u8, k, row_bytes)


def _unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(n/4,) uint8 packed 2-bit base codes -> (n,) uint8 codes 0..3:
    base 4i+m sits at bits 2m of packed[i]."""
    return torch.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3,
                        packed >> 6], dim=1).reshape(-1)


def _codes_ascii(codes: torch.Tensor) -> torch.Tensor:
    """uint8 base code 0..3 -> ASCII 'A'/'C'/'G'/'T' (65, 67, 71, 84)."""
    return 65 + 2 * codes + 2 * (codes >> 1) + 11 * (codes == 3).to(
        torch.uint8)


def _unpack_ascii(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The native reader's 2-bit codes + invalid bitmask
    (io/native/fastx_reader.cpp ktp_read_block_packed) -> the ASCII byte
    stream the plain reader would have produced: code 0..3 -> 'A'/'C'/
    'G'/'T', a masked slot (bit b of mask[i] for slot 8i+b) -> NUL.  A
    mask trimmed to a size class may cover more slots than the codes."""
    ascii_u8 = _codes_ascii(_unpack_codes(packed))
    inv = torch.stack([(mask >> b) & 1 for b in range(8)], dim=1).reshape(-1)
    return ascii_u8.masked_fill_(inv[: ascii_u8.shape[0]].bool(), 0)


def _structural_ascii(packed: torch.Tensor, n_used: int,
                      row_bytes: int) -> torch.Tensor:
    """Unpack without a transferred mask: the block is uniform rows with
    no in-read invalid base (see _iter_packed2), so the invalid slots
    are the last column of each row and every slot at or past n_used;
    the tail past the last whole row is zeros."""
    ascii_u8 = _codes_ascii(_unpack_codes(packed))
    n_rows = ascii_u8.shape[0] // row_bytes
    span = n_rows * row_bytes
    ascii_u8[:span].view(n_rows, row_bytes)[:, row_bytes - 1] = 0
    ascii_u8[min(n_used, span):] = 0
    return ascii_u8


def _extract_step_packed(packed: torch.Tensor, mask: torch.Tensor, k: int,
                         row_bytes, extract_flat, extract_rows):
    """Extract a packed block with a mask (kmer_tpu/pipeline/counter.py:
    458-463): unpack to ASCII, then the row-sliced form when row_bytes
    is given, the flat form otherwise."""
    ascii_u8 = _unpack_ascii(packed, mask)
    if row_bytes:
        return _extract_step_rows(ascii_u8, k, row_bytes, extract_rows)
    return extract_flat(ascii_u8, k)


def _extract_step_packed_structural(packed: torch.Tensor, n_used: int,
                                    k: int, row_bytes: int, extract_rows):
    """Extract a packed block whose mask was elided (counter.py:466-471)."""
    return _extract_step_rows(_structural_ascii(packed, n_used, row_bytes),
                              k, row_bytes, extract_rows)


def extract_row(row: torch.Tensor, k: int, row_bytes, aux, ingest: str,
                extract_flat, extract_rows):
    """One block's sentinelized keys and valid-lane count, on the block's
    device (the single engine's step, and the per-device body of
    kmer_tpu/dist/sharded.py:263-303).  ingest "ascii": `row` is the
    ASCII block; "packed": 2-bit codes, `aux` the invalid-slot mask;
    "packed_structural": codes whose mask was elided, `aux` the used-byte
    count.  The row-sliced form (`extract_rows`) runs when `row_bytes` is
    given, the flat form (`extract_flat`) otherwise."""
    if ingest == "packed":
        return _extract_step_packed(row, aux, k, row_bytes, extract_flat,
                                    extract_rows)
    if ingest == "packed_structural":
        return _extract_step_packed_structural(row, aux, k, row_bytes,
                                               extract_rows)
    if row_bytes:
        return _extract_step_rows(row, k, row_bytes, extract_rows)
    return extract_flat(row, k)


class InputError(OSError):
    """An input that the reader could not open or read.  Only
    `_staged_items` raises it, from the reader's own OSError, so a tool
    that answers it with "failed to open" catches nothing else."""


def _staged_items(it, pin: bool, prefetch: bool, st: IngestStats,
                  assemble=None, loop=trace.NULL):
    """Drive a reader iterator: each item's arrays staged (`_stage`, in
    pinned memory when `pin`), `assemble` applied first when given (the
    mesh's step grouping), all of it in a background thread when
    `prefetch`.  The reader's OSError re-raises as InputError; `st` takes
    the reader and wait times, and the waits are `ingest.wait` spans
    under the count loop's span `loop`."""
    it = _timed_iter(it, st)
    it = (assemble(it) if assemble is not None
          else (_stage(item, pin, loop) for item in it))
    if prefetch:
        it = _prefetch(it)
    while True:
        try:
            with trace.timed("ingest.wait", loop) as w:
                item = next(it)
        except StopIteration:
            st.wait_s += w.seconds
            return
        except OSError as e:
            err = InputError(*e.args)
            if e.filename is not None:
                err.filename = e.filename
            raise err from e
        st.wait_s += w.seconds
        yield item


def _extracted_blocks(paths: Sequence[str], k: int, block_bases: int,
                      capacity: int, qual_policy, device: torch.device,
                      prefetch: bool, extract_flat, extract_rows,
                      st: IngestStats, loop=trace.NULL):
    """The ingest loop that the count and yak engines share (the port's
    form of kmer_tpu/pipeline/yak.py:209-260): reader (`_iter_packed`,
    or `_iter_packed2` under packed ingest), staging in pinned memory
    for a CUDA device, non-blocking host->device copy, the unpack of a
    packed block, and the extraction kernel, in its row-sliced form
    (`extract_rows`) when every read of the block has one length and the
    flat form (`extract_flat`) otherwise.  Yields (keys, n_valid,
    n_bases, n_seqs, batch_end) a block, in reader order; `st` takes the
    reader, wait and dispatch times, and the spans go under the count
    loop's span `loop`."""
    packed_mode = _use_packed_ingest(paths)
    it = (_iter_packed2 if packed_mode else _iter_packed)(
        paths, k, block_bases, capacity, qual_policy, loop)
    for item in _staged_items(it, device.type == "cuda", prefetch, st,
                              loop=loop):
        with trace.timed("ingest.dispatch", loop) as d:
            if packed_mode:
                (row, mask, n_used, n_bases, n_seqs, row_bytes,
                 batch_end) = item
                aux, ingest = ((n_used, "packed_structural") if mask is None
                               else (mask.to(device, non_blocking=True),
                                     "packed"))
            else:
                row, n_bases, n_seqs, row_bytes, batch_end = item
                aux, ingest = None, "ascii"
            rb = row_bytes if row_bytes and row_bytes > k else None
            keys, n_kmers = extract_row(row.to(device, non_blocking=True),
                                        k, rb, aux, ingest, extract_flat,
                                        extract_rows)
        st.dispatch_s += d.seconds
        yield keys, n_kmers, n_bases, n_seqs, batch_end


@contextlib.contextmanager
def _maybe_profile():
    """KMER_TPU_PROFILE=<dir> traces the streaming loop with torch.profiler
    (host activity, and the card's when there is one) and writes a
    Chrome trace into <dir> when the loop ends, one file a loop
    (trace.<pid>.<ns>.json): the port's form of counter.py:280-296,
    which captures a jax.profiler trace there.  The trace holds the
    loop's `kmer.*` spans (utils/trace.py), the reader thread's too where
    torch's profiler takes every thread (`profile_all_threads`)."""
    out = os.environ.get("KMER_TPU_PROFILE")
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):  # a torch without the option
        prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out, f"trace.{os.getpid()}.{time.time_ns()}.json"))


class SortCountEngine:
    """Streaming counter on the sort-based compactor, on one device."""

    def __init__(
        self,
        k: int,
        block_bases: int = 10_000_000,
        budget_bytes: int = 2 << 30,
        prefetch: bool = True,
        qual_policy=None,
        device=None,
        plain_kernels: bool = False,
    ):
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.k = k
        self.block_bases = block_bases
        # separator headroom: one reference batch per buffer
        self.capacity = int(block_bases) + max(4096, int(block_bases) // 32)
        # False: the reader runs in the calling thread
        self.prefetch = prefetch
        self.qual_policy = qual_policy  # see io.fastx.FastxReader
        self.plain_kernels = plain_kernels
        self._extract = (extract.extract_keys_plain if plain_kernels
                         else extract.extract_keys)
        self._extract_rows = (extract.extract_keys_rows_plain
                              if plain_kernels else extract.extract_keys_rows)
        # hash64 output is < 2^(2k): for k <= 15 the stream ladder runs
        # one int32 plane (table/compactor.py)
        self.compactor = KmerCompactor(
            self.device, budget_bytes=budget_bytes, key_bits=2 * k,
            plain_kernels=plain_kernels,
        )
        self.total_bases = 0
        self.total_seqs = 0
        self.stats = IngestStats()  # refreshed per count_paths run
        # per-block valid-window counts stay on the device while
        # streaming; total_kmers sums them when asked
        self._nk_host = 0
        self._nk_dev: list = []

    @property
    def total_kmers(self) -> int:
        if self._nk_dev:
            self._nk_host += int(torch.stack(self._nk_dev).sum())
            self._nk_dev.clear()
        return self._nk_host

    @total_kmers.setter
    def total_kmers(self, v: int) -> None:
        self._nk_dev.clear()
        self._nk_host = int(v)

    def count_paths(self, paths: Sequence[str], progress=None,
                    tap=None) -> None:
        """Stream every path's k-mers into the compactor.  `progress`,
        when given, is called as progress(self) after each block.  `tap`,
        when given, is called per block as tap(keys, n_valid, n_seqs,
        batch_end) after the block is appended, on the same (row-sliced)
        key plane: single-file yak-count runs its admission simulation on
        it (tools/yak_count.py)."""
        st = self.stats = IngestStats()
        t_loop = time.perf_counter()
        lanes = 0
        with _maybe_profile(), trace.span("count.loop") as loop:
            for keys, n_kmers, n_bases, n_seqs, batch_end in \
                    _extracted_blocks(paths, self.k, self.block_bases,
                                      self.capacity, self.qual_policy,
                                      self.device, self.prefetch,
                                      self._extract, self._extract_rows, st,
                                      loop):
                with trace.timed("ingest.dispatch", loop) as d:
                    self.compactor.add_raw(keys)
                    lanes += int(keys.shape[0])
                    self.total_bases += int(n_bases)
                    self.total_seqs += n_seqs
                    self._nk_dev.append(n_kmers)
                    if tap is not None:
                        tap(keys, n_kmers, n_seqs, batch_end)
                st.dispatch_s += d.seconds
                if progress is not None:
                    progress(self)
            loop.set(lanes_added=lanes)
        st.loop_s = time.perf_counter() - t_loop

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h, self._n_distinct = self.compactor.hist(n_bins, max_count, min_keep)
        return h

    def counts_for(self, query_hi, query_lo) -> np.ndarray:
        return self.compactor.counts_for(query_hi, query_lo)

    def save_checkpoint(self, path: str) -> None:
        """Write the count state as the JAX package's SortCountEngine
        does (pipeline/counter.py:621-646): an .npz of the distinct keys
        as hi/lo uint32 planes, their uint32 counts and meta = int64[k,
        bases, seqs, kmers], written to a temporary file and renamed.
        The stream folds to one (key, count) run first."""
        self.compactor.compact()
        if self.compactor.runs:
            keys, cnt = self.compactor.runs[0]
            hi, lo = to_hi_lo(keys)
            cnt = cnt.cpu().numpy().view(np.uint32)
        else:
            hi = lo = cnt = np.zeros(0, np.uint32)
        tmp = path + ".tmp.npz"  # atomic publish: write, then rename
        np.savez_compressed(
            tmp, hi=hi, lo=lo, cnt=cnt,
            meta=np.asarray([self.k, self.total_bases, self.total_seqs,
                             self.total_kmers], np.int64))
        os.replace(tmp, path)

    @classmethod
    def resume_checkpoint(cls, path: str, **kw) -> "SortCountEngine":
        """Rebuild an engine from a checkpoint that either package's
        save_checkpoint wrote; counting can go on over further inputs,
        and the final histogram equals an uninterrupted run's."""
        z = np.load(path)
        k, tb, ts, tk = (int(x) for x in z["meta"])
        eng = cls(k=k, **kw)
        if z["hi"].size:
            keys = from_hi_lo(z["hi"], z["lo"], eng.device)
            counts = torch.from_numpy(
                np.asarray(z["cnt"], np.uint32).view(np.int32))
            eng.compactor.add_counted(keys, counts.to(eng.device))
        eng.total_bases, eng.total_seqs, eng.total_kmers = tb, ts, tk
        return eng

    from_jax_checkpoint = resume_checkpoint


def use_mesh() -> bool:
    """Whether the CLI tools count on the mesh (counter.py:666-679):
    KMER_TPU_FORCE_MESH=1 (true, on, yes) forces it, 0 (false, off, no)
    turns it off; by default it runs when more than one CUDA device is
    visible and the platform is not the CPU."""
    env = os.environ.get("KMER_TPU_FORCE_MESH", "").strip().lower()
    if env in ("1", "true", "on", "yes"):
        return True
    if env in ("0", "false", "off", "no"):
        return False
    return default_device().type == "cuda" and torch.cuda.device_count() > 1


def _assemble_step(items, k: int, packed_mode: bool, pin: bool,
                   loop=trace.NULL):
    """One mesh step from up to n_dev reader items (counter.py:723-771):
    (rows, row_bytes, aux, ingest, n_bases, n_seqs), rows staged as
    `_stage` stages a block.  row_bytes is kept only when every row
    shares it.  Packed items take the structural step when every row's
    mask was elided, else the masked one with the missing masks rebuilt
    on the host."""
    if not packed_mode:  # (buf, n_bases, n_seqs, row_bytes, batch_end)
        items = [(buf, None, 0, nb, ns, rb)
                 for buf, nb, ns, rb, _be in items]
    rbs = {it[5] for it in items}
    rb = rbs.pop() if len(rbs) == 1 else None
    if not packed_mode:
        aux, ingest = None, "ascii"
    elif rb is not None and rb > k and all(it[1] is None for it in items):
        aux, ingest = [int(it[2]) for it in items], "packed_structural"
    else:
        aux, ingest = [], "packed"
        for p, m, n, _nb, _ns, irb, *_ in items:
            if m is None:  # a structural row in a masked step
                pos = np.arange(4 * p.shape[0], dtype=np.int64)
                m = np.packbits((pos % irb == irb - 1) | (pos >= n),
                                bitorder="little")
            aux.append(m)
        aux = list(_stage(aux, pin, loop))
    rows = list(_stage([it[0] for it in items], pin, loop))
    return (rows, rb if rb and rb > k else None, aux, ingest,
            sum(int(it[3]) for it in items), sum(int(it[4]) for it in items))


def mesh_steps(paths: Sequence[str], k: int, row_bases: int, capacity: int,
               qual_policy, n_dev: int, packed_mode: bool, pin: bool,
               prefetch: bool, st: IngestStats, loop=trace.NULL):
    """The mesh's reader: n_dev reader items a step, the last step short
    (counter.py:773-804, yak.py:575-598), grouped and staged in the
    reader thread, its spans under `loop`.  Yields `_assemble_step`'s
    tuples."""
    it = (_iter_packed2 if packed_mode else _iter_packed)(
        paths, k, row_bases, capacity, qual_policy, loop)

    def assemble(items):
        group = []
        for item in items:
            group.append(item)
            if len(group) == n_dev:
                yield _assemble_step(group, k, packed_mode, pin, loop)
                group = []
        if group:
            yield _assemble_step(group, k, packed_mode, pin, loop)

    yield from _staged_items(it, pin, prefetch, st, assemble, loop)


class MeshSortCountEngine:
    """SortCountEngine's interface on the mesh (counter.py:682-842): the
    reader's blocks of row_bases bases go one to a shard, n_dev a step,
    and dist.sharded.ShardedSortEngine extracts, routes and counts them.
    The mesh's devices come from dist.sharded.default_devices unless
    `devices` names them."""

    def __init__(self, k: int, block_bases: int = 10_000_000,
                 budget_bytes: int = 2 << 30, prefetch: bool = True,
                 qual_policy=None, devices=None, plain_kernels: bool = False):
        from ..dist import sharded

        self.k = k
        self.mesh = sharded.make_mesh(devices)
        self.n_dev = self.mesh.size
        self.device = self.mesh.devices[0]
        # kc-c4's -b is bases a pipeline block; one mesh step consumes a
        # whole block, one row a shard
        self.row_bases = max(int(block_bases) // self.n_dev, 1 << 16)
        self.capacity = self.row_bases + max(4096, self.row_bases // 32)
        self.prefetch = prefetch
        self.qual_policy = qual_policy
        self.plain_kernels = plain_kernels
        self.eng = sharded.ShardedSortEngine(
            self.mesh, k, budget_bytes=budget_bytes,
            plain_kernels=plain_kernels)
        self.total_bases = 0
        self.total_seqs = 0
        self.stats = IngestStats()  # refreshed per count_paths run

    @property
    def total_kmers(self) -> int:
        return self.eng.total_kmers

    def count_paths(self, paths: Sequence[str], progress=None) -> None:
        """Stream every path's k-mers into the shards; `progress(self)`
        after each step."""
        st = self.stats = IngestStats()
        t_loop = time.perf_counter()
        pin = any(d.type == "cuda" for d in self.mesh.devices)
        with _maybe_profile(), trace.span("count.loop") as loop:
            for rows, rb, aux, ingest, n_bases, n_seqs in mesh_steps(
                    paths, self.k, self.row_bases, self.capacity,
                    self.qual_policy, self.n_dev, _use_packed_ingest(paths),
                    pin, self.prefetch, st, loop):
                with trace.timed("ingest.dispatch", loop) as d:
                    self.eng.add_batch(rows, row_bytes=rb, aux=aux,
                                       ingest=ingest)
                    self.total_bases += n_bases
                    self.total_seqs += n_seqs
                st.dispatch_s += d.seconds
                if progress is not None:
                    progress(self)
        st.loop_s = time.perf_counter() - t_loop

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h = self.eng.hist(n_bins, max_count, min_keep)
        self._n_distinct = self.eng._n_distinct
        return h

    def counts_for(self, query_hi, query_lo) -> np.ndarray:
        return self.eng.counts_for(query_hi, query_lo)

    def save_checkpoint(self, path: str) -> None:
        """The shards' planes (ShardedSortEngine.save_checkpoint) and the
        stream totals beside them in path + ".totals.npz"
        (counter.py:825-837)."""
        self.eng.save_checkpoint(path)
        tmp = path + ".totals.tmp.npz"
        np.savez(tmp, totals=np.asarray(
            [self.total_bases, self.total_seqs], np.int64))
        os.replace(tmp, path + ".totals.npz")

    def resume_checkpoint_into(self, path: str) -> None:
        """Load what save_checkpoint (of either package) wrote, on a mesh
        of the same shape; counting can go on over further inputs."""
        self.eng.restore_checkpoint(path)
        z = np.load(path + ".totals.npz")
        self.total_bases, self.total_seqs = (int(x) for x in z["totals"])


def make_count_engine(k: int, block_bases: int = 10_000_000,
                      budget_bytes: int = 2 << 30, prefetch: bool = True,
                      qual_policy=None):
    """The CLI tools' engine factory (counter.py:845-866): the engine of
    every process's shards in a run of several (torch.distributed
    initialized, dist.multihost.initialize), the mesh engine when
    use_mesh(), else one engine on the default device (see
    default_device).  All give the same histograms and counts."""
    from ..dist import multihost, sharded

    if sharded.process_count() > 1:
        cls = multihost.MultihostSortEngine
    else:
        cls = MeshSortCountEngine if use_mesh() else SortCountEngine
    return cls(k, block_bases, budget_bytes, prefetch, qual_policy)
