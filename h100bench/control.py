#!/usr/bin/env python3
"""The control of `correct`: the plain reference put in the program's
place and computed with a guarantee broken (each k-mer cut to a 32-bit
fingerprint, the lossy key a faster table would tempt one to keep), its
outputs judged by the same comparison as a run's.  It has to come out
not correct, on every seed.

Usage: python3 h100bench/control.py --workload <cell> --seed <n> [...]

Makes the cell's inputs at the cell's own size from each seed, one job
of each input the traffic cycles through, and prints one JSON line a
seed with the checks.  Runs on the card when there is one.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(cell, seed: int, workdir: str) -> dict:
    """The checks of a run whose jobs printed the control's outputs, and
    whose set-up files are the reference's own."""
    from h100bench import gen, harness
    from h100bench.spec import load_module

    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)
    inputs = gen.make_inputs(cell.config, seed, workdir, 0, cell.base)
    m = int(cell.traffic.get("inputs_per_job", 1))
    jobs = [harness.plan(cell, inputs, workdir, n)
            for n in range(-(-len(inputs.files) // m))]
    check = load_module("checks", cell.traffic["check"], cell.base)
    dev = harness.reference_device()
    fake = check.expected(inputs, cell, sorted({j.files for j in jobs}),
                          dev, control=True)
    for j in jobs:  # the check's `got` reads stdout then the [M lines
        j.rc, j.text = 0, fake["jobs"][j.files]
        j.err = j.text
    for name, text in fake.get("setup", {}).items():
        with open(harness.fill(cell, inputs, workdir)[name], "w",
                  encoding="latin-1") as f:
            f.write(text)
    return harness.judge(cell, inputs, jobs, workdir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from h100bench import harness, spec

    cell = spec.load_cell(args.workload)
    for seed in args.seed:
        workdir = tempfile.mkdtemp(prefix="h100bench.control.")
        try:
            checks = control_checks(cell, seed, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        correct = all(v <= lim for v, lim in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": str(harness.reference_device()),
                          "correct": correct, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
