#!/usr/bin/env python3
"""tune_resolve.py — time the slot-resolve kernel's variants side by side.

Usage: python3 scripts/tune_resolve.py [--variants 256:2,256:1,...]
                                       [--reps 3] [--seed N] [--out DIR]
                                       [--baseline TABLE_CU]

Runs on one CUDA GPU.  kmer_tpu_torch/csrc/table.cu takes its shape from
the KTT_RESOLVE_THREADS (threads a block, a lane a thread) and
KTT_RESOLVE_TAIL_PER_THREAD (lanes a thread takes in the one-block
tail: the tail starts at threads x this many survivors; its two lists of
16-byte entries must fit 48 KB of static shared memory) macros; a
variant is threads:tail_per_thread.  The script builds
table.cu + common.cu once per variant (all nvcc processes started
together, into build/kmer_tpu_torch/tune/) and times each variant in
turns, forwards then backwards, through kernels/table.py's
resolve_slots_kernel with the variant's library loaded in place of the
default one, on chip_smoke.py's three phase 16 cases (the first three
10 Mbase blocks of its 256 Mbase file, made or read from
build/chip_smoke/: block 1 into a fresh table, block 3 into 2^25 slots
holding blocks 1-2 and their tombstones, lookups of block 1 after block
3; and block 1's lookups in the fresh table, round 0 alone without a
claim), plus a round's floor in the one-block tail and on the grid.  Every
variant's result is first held against resolve_slots_plain, bit for
bit.  With --baseline, an earlier table.cu whose C entry is the
per-round `ktt_resolve_round` (two launches a round, the host reading
the survivor count after each) is built as it is and timed in the same
turns under the name "baseline".  With --out, nvcc's `-Xptxas -v`
report of every variant goes to DIR/tune_resolve_ptxas.txt.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = "256:2,256:1,256:4,512:1"
MACROS = ("THREADS", "TAIL_PER_THREAD")


def build(variants, out_dir, baseline=None):
    """One shared library per variant (and one of the baseline); returns
    {name: CDLL}."""
    from kmer_tpu_torch.kernels import _build

    tune_dir = os.path.join(_build.BUILD_DIR, "tune")
    os.makedirs(tune_dir, exist_ok=True)
    common = os.path.join(_build.CSRC, "common.cu")
    srcs = {v: os.path.join(_build.CSRC, "table.cu") for v in variants}
    if baseline:
        srcs["baseline"] = baseline
    procs = {}
    for name, src in srcs.items():
        defs = ([] if name == "baseline" else
                [f"-DKTT_RESOLVE_{m}={x}"
                 for m, x in zip(MACROS, name.split(":"))])
        so = os.path.join(tune_dir, f"libresolve_{name.replace(':', '_')}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs,
             "-shared", "-o", so, src, common],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, report = {}, []
    for name, (so, p) in procs.items():
        _out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        report.append(f"== {name}\n{err}")
        libs[name] = ctypes.CDLL(so)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "tune_resolve_ptxas.txt"), "w") as f:
            f.write("\n".join(report))
    return libs


def use(lib):
    """Load `lib` in place of the kernels' library (the entries it has)."""
    from kmer_tpu_torch.kernels import _build

    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ktt_error_string.argtypes = [ctypes.c_int]
    lib.ktt_error_string.restype = ctypes.c_char_p
    _build._lib = lib


def baseline_resolve(lib, state, tkey, keys, valid, create_new):
    """The per-round form: per round, the baseline's probe and decide
    launches, then a host read of the survivor count."""
    import torch

    from kmer_tpu_torch.kernels import table as kt

    P, I64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.ktt_resolve_round
    fn.argtypes = [P, I64, I64, P, P, P, P, P, I64, P, P, P, P, P, P, P,
                   I64, ctypes.c_int, P]
    cap, m, dev = state.shape[0], keys.shape[0], keys.device
    lanes = torch.nonzero(valid).flatten().to(torch.int32)
    n = lanes.shape[0]
    nxt = torch.empty_like(lanes)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    pos_slot = torch.empty(n, dtype=torch.int32, device=dev)
    pos_case = torch.empty(n, dtype=torch.uint8, device=dev)
    off = torch.zeros(m, dtype=torch.int32, device=dev)
    slot = torch.full((m,), cap, dtype=torch.int64, device=dev)
    found = torch.zeros(m, dtype=torch.bool, device=dev)
    created = torch.zeros(cap, dtype=torch.bool, device=dev)
    ticket = torch.zeros(cap if create_new else 1, dtype=torch.int32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rnd = probes = 0
    while n:
        probes += n
        rc = fn(keys.data_ptr(), m, cap, state.data_ptr(), tkey.data_ptr(),
                ticket.data_ptr(), off.data_ptr(), lanes.data_ptr(), n,
                nxt.data_ptr(), count.data_ptr(), pos_slot.data_ptr(),
                pos_case.data_ptr(), slot.data_ptr(), found.data_ptr(),
                created.data_ptr(), rnd, int(create_new), stream)
        if rc:
            raise RuntimeError(f"ktt_resolve_round failed: {rc}")
        n = int(count.item())
        lanes, nxt = nxt, lanes
        rnd += 1
    return kt.Resolved(slot, found, created, rnd, probes)


def cases(blocks, dev):
    """chip_smoke.py phase 16's three cases and block 1's lookups in a
    fresh table (one round, no claim): (label, table, keys,
    create_new)."""
    from kmer_tpu_torch.kernels import bloom
    from kmer_tpu_torch.kernels.keys import SENT
    from kmer_tpu_torch.pipeline import yak
    from kmer_tpu_torch.pipeline.counter import GROW_LOAD
    from kmer_tpu_torch.table import count_table as ct

    n1 = int((blocks[0] != SENT).sum())
    cap = 1 << 20
    while n1 > GROW_LOAD * cap:
        cap *= 2
    # block 1 looked up in that empty table: round 0 alone, no claim
    out = [("fresh", ct.make(cap, dev), blocks[0], True),
           ("fresh lookups", ct.make(cap, dev), blocks[0], False)]
    spec = bloom.BloomSpec(10, 30, 4)
    bits = bloom.make_bits(spec, dev)
    t = ct.make(1 << 25, dev)
    for keys in blocks[:2]:
        v = keys != SENT
        bits, preset = bloom.insert_sequential(bits, keys, v, spec)
        t, _n, _d = ct.insert_gated(t, keys, v, preset, yak.YAK_MAX_COUNT)
    out.append(("tombstones", t, blocks[2], True))
    v = blocks[2] != SENT
    bits, preset = bloom.insert_sequential(bits, blocks[2], v, spec)
    c = ct.CountTable(t.state.clone(), t.key.clone(), t.cnt.clone(),
                      t.n_full.clone())
    c, _n, _d = ct.insert_gated(c, blocks[2], v, preset, yak.YAK_MAX_COUNT)
    out.append(("lookups", c, blocks[0], False))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("tune_resolve: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.kernels import table as kt
    from kmer_tpu_torch.kernels.keys import SENT

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    variants = args.variants.split(",")
    libs = build(variants, args.out, args.baseline)
    dev = torch.device("cuda")
    blocks = cs.first_blocks(cs.reads_file(cs.MBASES, args.seed), 3)
    todo = cases(blocks, dev)
    names = list(libs)

    def call(name, st, tk, keys, valid, create_new):
        if name == "baseline":
            return baseline_resolve(libs[name], st, tk, keys, valid,
                                    create_new)
        use(libs[name])
        return kt.resolve_slots_kernel(st, tk, keys, valid, create_new)

    for label, table, keys, create_new in todo:
        valid = keys != SENT
        want = kt.resolve_slots_plain(table.state.clone(), table.key.clone(),
                                      keys, valid, create_new)
        for name in names:
            st, tk = table.state.clone(), table.key.clone()
            got = call(name, st, tk, keys, valid, create_new)
            same = (torch.equal(got.slot, want.slot)
                    and torch.equal(got.found, want.found)
                    and torch.equal(got.created, want.created)
                    and (got.rounds, got.probes) == (want.rounds,
                                                     want.probes))
            if not same:
                raise SystemExit(f"{name} != plain on {label}")
        ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(cs.time_ms(
                lambda p, n=name: call(n, *p, keys, valid, create_new),
                lambda: (table.state.clone(), table.key.clone()),
                reps=args.reps))
        nbytes = cs.resolve_bytes(want, keys.shape[0], table.capacity)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(f"{label}: {keys.shape[0]} lanes into {table.capacity} slots, "
              f"{want.rounds} rounds, {want.probes} probe-lanes; bound "
              f"{bound:.4f} ms", flush=True)
        for name in names:
            t = sum(ms[name]) / len(ms[name])
            print(f"  {name:>12}: {' / '.join(f'{x:.4f}' for x in ms[name])}"
                  f" ms, mean {t:.4f} ({100 * bound / t:.1f}% of the bound)",
                  flush=True)
    for name in names:
        if name == "baseline":
            continue
        use(libs[name])
        tail = kt.kernel_shape(dev)
        floors = [cs.round_floor_ms(dev, lanes)
                  for lanes in (1, 4 * tail["tail_lanes"])]
        print(f"floor {name:>12}: tail {floors[0]:.5f} ms, grid "
              f"{floors[1]:.5f} ms; grid {tail['blocks']} blocks "
              f"({tail['blocks_per_sm']} a SM), {tail['registers']} "
              f"registers", flush=True)
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
