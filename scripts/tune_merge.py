#!/usr/bin/env python3
"""tune_merge.py — time the merge path's tile shapes side by side.

Usage: python3 scripts/tune_merge.py [--shapes 256x16,512x16,...]
                                     [--lg 25] [--reps 5] [--seed N]
                                     [--out DIR] [--baseline MERGE_CU]

Runs on one CUDA GPU.  kmer_tpu_torch/csrc/merge.cu takes its tile shape
(threads a block x lanes a thread) for each lane type from the
KTT_MERGE*_THREADS / KTT_MERGE*_PER_THREAD macros.  This script builds
the file once per shape (all nvcc processes started together, into
build/kmer_tpu_torch/tune/), giving every lane type that shape, and for
each lane type (int64 keys, int32 keys, (int64 key, int64 index) lanes)
merges two sorted 2^(lg-1)-lane runs with every shape in turns, forwards
and then backwards: merge_partition and merge_path, kernel launches only
(the output is allocated once).  Each result is first held against a
sort of the concatenation, lane for lane.  It prints the shape's tile,
its shared memory, both times, their sum and the byte bound at 3.35 TB/s;
a shape whose tile does not fit a block's 227 KB of shared memory is
skipped for that lane type.  With --out, nvcc's `-Xptxas -v` report
(registers, spills) of every shape goes to DIR/tune_merge_ptxas.txt.
--baseline names another merge.cu with the same C interface (an earlier
commit's, unpacked with `git archive`): it is built as it is and timed
in the same turns under the name "baseline", for the lane types it has.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = "128x16,256x8,256x16,256x32,512x8,512x16,1024x8"
SMEM_LIMIT = 232_448  # bytes of shared memory one block can opt in to
HBM_BYTES_PER_S = 3.35e12
# lane type -> (suffix of its entry points and macros, bytes a lane)
LANES = {"int64": ("", 8), "int32": ("1", 4), "key_idx": ("3", 16)}


def build(shapes, out_dir, baseline=None):
    """One shared library per shape (and one of the baseline source as
    it is); returns {shape: CDLL}."""
    from kmer_tpu_torch.kernels import _build

    tune_dir = os.path.join(_build.BUILD_DIR, "tune")
    os.makedirs(tune_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, "merge.cu")
    procs = {}
    for shape in shapes:
        threads, per = shape.split("x")
        defs = [f"-DKTT_MERGE{sfx}_{what}={val}"
                for sfx, _ in LANES.values()
                for what, val in (("THREADS", threads), ("PER_THREAD", per))]
        so = os.path.join(tune_dir, f"libmerge_{shape}.so")
        procs[shape] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs,
             "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    if baseline:
        so = os.path.join(tune_dir, "libmerge_baseline.so")
        procs["baseline"] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", so, baseline],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, report = {}, []
    for shape, (so, p) in procs.items():
        _out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{err}")
        report.append(f"== {shape}\n{err}")
        libs[shape] = ctypes.CDLL(so)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "tune_merge_ptxas.txt"), "w") as f:
            f.write("\n".join(report))
    return libs


def runs_of(lanes, n, g, dev):
    """Two sorted runs of n // 2 lanes (15% sentinels) as plane tuples,
    and the sorted whole."""
    import torch

    from kmer_tpu_torch.kernels.keys import SENT, SENT32

    half = n // 2
    mask = torch.rand(n, generator=g, device=dev) < 0.15
    if lanes == "int32":
        v = torch.randint(0, 1 << 30, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        v[mask] = SENT32
    else:
        pool = n // 4 if lanes == "key_idx" else n
        v = torch.randint(-(1 << 62), 1 << 62, (pool,), generator=g,
                          device=dev)
        if lanes == "key_idx":
            v = v[torch.randint(0, pool, (n,), generator=g, device=dev)]
        v[mask] = SENT
    if lanes != "key_idx":
        return ((torch.sort(v[:half]).values,), (torch.sort(v[half:]).values,),
                (torch.sort(v).values,))
    idx = torch.arange(n, device=dev) + (1 << 31)

    def run(lo, hi):  # the index rises: a stable key sort is (key, index)
        k, o = torch.sort(v[lo:hi], stable=True)
        return k, idx[lo:hi][o]

    return run(0, half), run(half, n), run(0, n)


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def tune(lanes, libs, lg, reps, g, dev):
    import torch

    sfx, lane_bytes = LANES[lanes]
    n = 1 << lg
    a, b, want = runs_of(lanes, n, g, dev)
    out = tuple(torch.empty_like(w) for w in want)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = ctypes.c_void_p
    i64 = ctypes.c_int64
    a_args = [ptr(p.data_ptr()) for p in a] + [i64(n // 2)]
    b_args = [ptr(p.data_ptr()) for p in b] + [i64(n // 2)]
    calls = {}
    for shape, lib in libs.items():
        if not hasattr(lib, f"ktt_merge_path{sfx}"):
            continue  # a baseline without this lane type
        tile = getattr(lib, f"ktt_merge_tile_lanes{sfx}")()
        # the baseline's shape is not known here: its 4096-lane int64
        # tile held one pad lane every 16
        threads = int(shape.split("x")[0]) if "x" in shape else tile // 16
        smem = (tile + threads) * lane_bytes
        if smem > SMEM_LIMIT:
            print(f"[{lanes}] {shape}: tile {tile} needs {smem} B of shared "
                  "memory: skipped", flush=True)
            continue
        splits = torch.empty(n // tile + 1, dtype=torch.int64, device=dev)
        part = getattr(lib, f"ktt_merge_partition{sfx}")
        path = getattr(lib, f"ktt_merge_path{sfx}")
        part.restype = path.restype = ctypes.c_int

        def partition(part=part, splits=splits):
            rc = part(*a_args, *b_args, ptr(splits.data_ptr()), ptr(stream))
            assert rc == 0, f"merge_partition{sfx} launch: CUDA error {rc}"

        def merge(path=path, splits=splits):
            rc = path(*a_args, *b_args, ptr(splits.data_ptr()),
                      *[ptr(o.data_ptr()) for o in out], ptr(stream))
            assert rc == 0, f"merge_path{sfx} launch: CUDA error {rc}"

        for o in out:
            o.zero_()
        partition()
        merge()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(out, want)):
            raise RuntimeError(f"[{lanes}] {shape}: the merge differs from "
                               "the sort")
        calls[shape] = (tile, smem, partition, merge)
    times = {shape: [[], []] for shape in calls}
    for shape in [*calls, *reversed(calls)]:  # in turns, both ways round
        _tile, _smem, partition, merge = calls[shape]
        times[shape][0].append(time_ms(partition, reps))
        times[shape][1].append(time_ms(merge, reps))
    bound = 2 * lane_bytes * n / HBM_BYTES_PER_S * 1e3
    for shape, (tile, smem, _p, _m) in calls.items():
        part_ms, path_ms = (sum(t) / len(t) for t in times[shape])
        print(f"[{lanes}] 2^{lg} lanes, {shape}: tile {tile}, shared "
              f"{smem} B, merge_path{sfx} {path_ms:.4f} ms + "
              f"merge_partition{sfx} {part_ms:.4f} ms = "
              f"{path_ms + part_ms:.4f} ms; bound {bound:.4f} ms "
              f"({100 * bound / path_ms:.1f}% for merge_path{sfx})",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--lg", type=int, default=25)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("tune_merge: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    print(r.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = build(args.shapes.split(","), args.out, args.baseline)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for lanes in LANES:
        tune(lanes, libs, args.lg, args.reps, g, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
