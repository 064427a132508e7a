"""yak-count on the PyTorch/CUDA engine (port of
kmer_tpu/tools/yak_count.py:17-152).

Same flags, usage and error text, exit codes and stdout (1023
`count\tnum_distinct` rows), and the same `[M` stderr lines.  With one
input file (or the same file twice) the bloom-filtered two-pass result
is {key: count >= 2} with exact saturated counts, so one counting pass
on the sort engine with a min-count filter gives it, and the per-batch
`[M] processed ...` lines come from the admission simulation riding the
same key planes (pipeline/yak.py `YakSimTap`); pass 2's lines repeat the
pre-shrink total.  KMER_TPU_FAST_YAK=1 skips the simulation and prints
one summary line instead.  With two different files, where the bloom's
false positives show in the output, the two-pass engine runs as the
reference does (pipeline/yak.py `SortYakEngine`, `yak_count_file`).  On
the mesh (pipeline/counter.py `use_mesh`), and in a run of several
processes, the count engine and the two-file engine are the mesh's, and
one file prints a single `[M` line for its whole pass; stdout comes from
process 0 alone (utils.log.is_primary).  The -t flag is accepted for
CLI parity.
"""

from __future__ import annotations

import os
import sys

from ..dist.sharded import process_count
from ..pipeline.counter import InputError, make_count_engine, use_mesh
from ..pipeline.yak import (YAK_COUNTER_BITS, YAK_MAX_COUNT, YAK_N_COUNTS,
                            YakSimTap, make_yak_engine, yak_count_file)
from ..utils.cli import c_atoi, ketopt
from ..utils.log import is_primary


def _log(n_seqs, tot):
    sys.stderr.write(
        f"[M] processed {n_seqs} sequences; {tot} distinct k-mers in the hash table\n"
    )


def _print_rows(h):
    if is_primary():  # one histogram a run, not one a process
        sys.stdout.write("\n".join(f"{i}\t{h[i]}"
                                   for i in range(1, YAK_N_COUNTS)) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k, pre, chunk, n_thread, bf_shift, bf_n_hash = 31, 10, 10_000_000, 4, 0, 4
    opts, pos = ketopt(argv, "k:p:K:t:b:H:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "p":
            pre = c_atoi(a)
        elif c == "K":
            chunk = c_atoi(a)
        elif c == "t":
            n_thread = c_atoi(a)
        elif c == "b":
            bf_shift = c_atoi(a)
        elif c == "H":
            bf_n_hash = c_atoi(a)
    if len(pos) < 1:
        e = sys.stderr
        e.write("Usage: yak-count [options] <in.fa> [in.fa]\n")
        e.write("Options:\n")
        e.write(f"  -k INT     k-mer size [{k}]\n")
        e.write(f"  -p INT     prefix length [{pre}]\n")
        e.write(
            f"  -b INT     set Bloom filter size to 2**INT bits; 0 to disable [{bf_shift}]\n"
        )
        e.write(f"  -H INT     use INT hash functions for Bloom filter [{bf_n_hash}]\n")
        e.write(f"  -t INT     number of worker threads [{n_thread}]\n")
        e.write("  -K INT     chunk size [100m]\n")
        e.write("Note: -b37 is recommended for human reads\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    if pre < YAK_COUNTER_BITS:
        sys.stderr.write(f"ERROR: -p should be at least {YAK_COUNTER_BITS}\n")
        return 1
    if len(pos) >= 2 and pos[1] != pos[0]:
        return _two_files(pos[0], pos[1], k, pre, chunk, bf_shift,
                          bf_n_hash)

    fast = os.environ.get("KMER_TPU_FAST_YAK", "").strip().lower() in (
        "1", "true", "on", "yes")
    # the mesh's steps are partitioned by device, so it prints one
    # summary line instead of the per-batch simulation (yak_count.py:
    # 87-103; PARITY.md divergence 8)
    mesh_like = process_count() > 1 or use_mesh()
    eng = make_count_engine(k=k, block_bases=chunk,
                            qual_policy=("resume", k, 3))
    sim = None
    if not fast and not mesh_like:
        sim = YakSimTap(pre=pre, bf_shift=bf_shift, bf_n_hash=bf_n_hash,
                        log=_log, device=eng.device,
                        plain_kernels=eng.plain_kernels)
        sim.begin_batches()
    try:
        if sim is not None:
            eng.count_paths([pos[0]], tap=sim.ingest_planes)
        else:
            eng.count_paths([pos[0]])
    except InputError:
        sys.stderr.write(f"Error: failed to open {pos[0]}\n")
        return 1
    min_keep = 2 if bf_shift > 0 else 1
    if sim is not None:
        sim.finish_batches()
        if bf_shift > 0:
            # pass 2 re-reads the same file: identical batches, no
            # inserts, so every line repeats the pass-1 total
            for n in sim.batch_seq_counts:
                _log(n, sim.tot)
    h = eng.hist(YAK_N_COUNTS, max_count=YAK_MAX_COUNT, min_keep=min_keep)
    tot = eng._n_distinct
    if sim is None:
        _log(eng.total_seqs, tot)
    sys.stderr.write(f"[M::main] {tot} distinct k-mers after shrinking\n")
    _print_rows(h)
    return 0


def _two_files(fn1, fn2, k, pre, chunk, bf_shift, bf_n_hash):
    """Pass 1 counts fn1 behind the bloom, pass 2 counts fn2 against
    fn1's admitted keys, then the shrink (yak_count.py:125-144)."""
    eng = make_yak_engine(k=k, pre=pre, bf_shift=bf_shift,
                          bf_n_hash=bf_n_hash, chunk_size=chunk, log=_log)
    try:
        yak_count_file(fn1, fn2, eng)
    except InputError as exc:
        # a clean failure where the C original segfaults, as in JAX
        sys.stderr.write(f"Error: failed to open {exc.filename or fn1}\n")
        return 1
    h = eng.hist()
    sys.stderr.write(
        f"[M::main] {eng.tot} distinct k-mers after shrinking\n")
    _print_rows(h)
    return 0
