#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

Usage (from the root of a checkout):

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Prints the checks that decide `correct` as its last lines on standard
error and one JSON object as the last line of standard output.  Exits 3
without a result when CUDA is not available or has fewer cards than the
cell asks for, or when the cell asks for more cards than the harness
drives (one), and 4 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "h100bench", sub)
    sys.path.insert(0, ROOT)
    from h100bench import harness, spec

    cell = spec.load_cell(args.workload)
    if cell.chips > harness.LocalRunner.cards:
        sys.stderr.write(f"h100bench: {args.workload} asks for {cell.chips}"
                         f" cards; the harness runs a cell's jobs in one "
                         f"process on {harness.LocalRunner.cards}\n")
        return 3
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"h100bench: {args.workload} needs {cell.chips} "
                         f"CUDA device(s); found "
                         f"{torch.cuda.device_count()}\n")
        return 3
    workdir = tempfile.mkdtemp(prefix="h100bench.")
    try:
        res = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), T_START, workdir)
    except harness.ForeignModules as e:
        sys.stderr.write(f"h100bench: {e}\n")
        return 4
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, c in res["checks"].items():
        sys.stderr.write(f"check {name} {c['value']} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
