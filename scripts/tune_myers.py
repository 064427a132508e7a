#!/usr/bin/env python3
"""tune_myers.py — time the Myers kernel's variants side by side.

Usage: python3 scripts/tune_myers.py [--variants 4:2,2:2,...]
                                     [--reps 5] [--seed N] [--out DIR]
                                     [--baseline MYERS_CU]

Runs on one CUDA GPU.  kmer_tpu_torch/csrc/myers.cu takes its shape from
the KTT_MYERS_K1 (patterns a thread for one word) and KTT_MYERS_KW (for
2-4 words) macros; a variant is k1:kw.  The script builds myers.cu +
common.cu once per variant (all nvcc processes started together, into
build/kmer_tpu_torch/tune/), holds every variant's counts and sums
against the plain versions on the card, lane for lane, and times the
variants in turns, forwards then backwards, through kernels/myers.py's
wrappers with the variant's library loaded in place of the default one,
on chip_smoke.py's shapes: ed-vaf-counter's batch at 1,000 sites (2,048
reads of 150 bases x 2,000 patterns of 21 bases; counts and sums), at
the 21,000-site panel (x 42,000 patterns; sums) and phase 11's
long-pattern batch (x 256 patterns of 45 and 97 bases, W = 4; counts
and sums).  The baseline, an earlier myers.cu (by default
scripts/myers_baseline.cu, the one-lane form: a thread a lane, the
masked step), is built as it is and timed in the same turns through its
own (R, P) entries.  Each variant's loop is counted in its SASS
(instructions and ALU-pipe instructions a lane-step, chip_smoke.py
sass_per_step) beside the issue and ALU-pipe bounds.  With --out, nvcc's `-Xptxas -v` report of every
variant goes to DIR/tune_myers_ptxas.txt.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = "4:2,2:2,4:4"
MACROS = ("K1", "KW")


def build(variants, out_dir, baseline):
    """One shared library per variant and one of the baseline; returns
    {name: path}."""
    from kmer_tpu_torch.kernels import _build

    tune_dir = os.path.join(_build.BUILD_DIR, "tune")
    os.makedirs(tune_dir, exist_ok=True)
    common = os.path.join(_build.CSRC, "common.cu")
    srcs = {v: os.path.join(_build.CSRC, "myers.cu") for v in variants}
    srcs["baseline"] = baseline
    procs = {}
    for name, src in srcs.items():
        defs = ([] if name == "baseline" else
                [f"-DKTT_MYERS_{m}={x}"
                 for m, x in zip(MACROS, name.split(":"))])
        so = os.path.join(tune_dir, f"libmyers_{name.replace(':', '_')}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs,
             "-shared", "-o", so, src, common],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    paths, report = {}, []
    for name, (so, p) in procs.items():
        _out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        report.append(f"== {name}\n{err}")
        paths[name] = so
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "tune_myers_ptxas.txt"), "w") as f:
            f.write("\n".join(report))
    return paths


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


def shapes():
    # label, reads, pattern lengths, patterns, words (None: one), max_e
    return (("tool", 2048, [21], 2000, None, 1),
            ("panel", 2048, [21], 42000, None, 1),
            ("long", 2048, [45, 97], 256, 4, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--baseline",
                    default=os.path.join(ROOT, "scripts", "myers_baseline.cu"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("tune_myers: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kmer_tpu_torch.kernels import _build, myers

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    variants = args.variants.split(",")
    paths = build(variants, args.out, args.baseline)
    libs = {name: ctypes.CDLL(p) for name, p in paths.items()}
    names = list(libs)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    mhz = cs.sm_clock_mhz() or 1980.0
    issue, pipe = cs.int_rates(mhz)

    for label, n_reads, pat_lens, n_pat, n_words, max_e in shapes():
        (pc, plen, codes, lens), _every = cs.myers_batch(
            rng, dev, n_reads, pat_lens, n_pat, 4, 1024, (150, 150), 4)
        if n_words is None:
            peq = myers.build_peq(pc, plen, 4)
            kern = myers.myers_hw_counts_kernel
            ksum = myers.myers_hw_sums_kernel
            plain, more = myers.myers_hw_counts_plain, ()
        else:
            peq = myers.build_peq_multiword(pc, plen, 4, n_words)
            kern = myers.myers_hw_counts_multiword_kernel
            ksum = myers.myers_hw_sums_multiword_kernel
            plain, more = myers.myers_hw_counts_multiword_plain, (n_words,)
        a = (peq, plen, codes, lens, max_e)
        want = plain(*a, *more)
        want_sum = want.sum(0, dtype=torch.int64)
        total = torch.zeros(n_pat, dtype=torch.int64, device=dev)
        runs = {}
        for name in names:
            if name == "baseline":
                got = cs.baseline_counts(libs[name], *a, n_words)
                if not torch.equal(got, want):
                    raise SystemExit(f"baseline != plain on {label}")
                runs[(name, "counts")] = (
                    lambda n=name: cs.baseline_counts(libs[n], *a, n_words))
                continue
            use(libs[name])
            if label != "panel":
                if not torch.equal(kern(*a, *more), want):
                    raise SystemExit(f"{name} counts != plain on {label}")
            s = ksum(*a, *more, torch.zeros_like(total))
            if not torch.equal(s, want_sum):
                raise SystemExit(f"{name} sums != plain on {label}")
            if label != "panel":
                runs[(name, "counts")] = lambda: kern(*a, *more)
            runs[(name, "sums")] = lambda: ksum(*a, *more, total)
        del want
        keys = list(runs)
        ms = {k: [] for k in keys}
        for k in keys + keys[::-1]:
            if k[0] != "baseline":
                use(libs[k[0]])  # outside the timed run
            ms[k].append(cs.time_run_ms(runs[k], args.reps))
        steps, ops, alu, nbytes = cs.myers_work(plen, lens, 1024, n_words, 4)
        bound_s, by = cs.myers_bound_s(ops, alu, nbytes, mhz)
        print(f"{label}: {n_reads} reads x {n_pat} patterns, W "
              f"{n_words or 1}, {steps} lane-steps; operation bound "
              f"{bound_s * 1e3:.4f} ms ({by})", flush=True)
        base = ms.get(("baseline", "counts"))
        for k in keys:
            t = sum(ms[k]) / len(ms[k])
            vs = (f", {sum(base) / len(base) / t:.2f}x the baseline"
                  if base and k[0] != "baseline" else "")
            print(f"  {k[0]:>10} {k[1]:>6}: "
                  f"{' / '.join(f'{x:.4f}' for x in ms[k])} ms, mean "
                  f"{t:.4f} ({100 * bound_s * 1e3 / t:.1f}% of the operation "
                  f"bound{vs})", flush=True)
        sym = "myers_regsILi1E" if n_words is None else "myers_regsILi4E"
        if label == "panel":
            continue
        for name in names:
            if name == "baseline":
                k = 1
            else:
                use(libs[name])
                k = myers.kernel_shape(n_reads, n_pat, 4, n_words or 1,
                                       True, dev)["patterns"]
            got = cs.myers_sass(sym, steps, k, mhz, paths[name])
            if got is None:
                print(f"  {name:>10} SASS: not measured (no loop over the "
                      "read's codes or no cuobjdump)", flush=True)
                continue
            text, per, alu_per, issue_s, pipe_s = got
            print(f"  {name:>10} SASS: {text}; issue bound "
                  f"{issue_s * 1e3:.4f} ms, ALU-pipe bound "
                  f"{pipe_s * 1e3:.4f} ms (at {mhz:.0f} MHz: "
                  f"{issue:.4g} / {pipe:.4g} lane-ops/s)", flush=True)
    for name in names:
        if name == "baseline":
            continue
        use(libs[name])
        for w in (1, 4):
            sh = myers.kernel_shape(2048, 42000 if w == 1 else 256, 4, w,
                                    True, dev)
            print(f"shape {name:>10} W {w}: {sh}", flush=True)
    _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
