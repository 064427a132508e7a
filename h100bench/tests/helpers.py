"""Small cells for the CPU tests: the cells of BENCHMARK.json with their
configurations cut to a size a test run holds."""

import os
import tempfile

from h100bench import harness, spec

SMALL = {
    "reads": {"genome.bases": 60_000, "reads.count": 4_000},
    "snp_cohort": {"genome.bases": 600_000,
                   "reference_fasta.bases": 400_000, "panel.sites": 300,
                   "cohort.bases_per_sample": 150_000},
}


# a bloom of 2^19 bits (one 512-bit block a subtable) and 100 kbase
# batches, so that a small input has false positives and several batches
SMALL_TRAFFIC = {"yak_b30_file": {"bloom_bits": 19, "chunk": 100_000}}
CELLS = ["mabs_kc_c4", "ngscm_vaf", "mabs_yak_b30"]


def small_cell(name, **extra):
    cell = spec.load_cell(name)
    cfg = cell.config
    for path, value in {**SMALL[cfg["data"]], **extra}.items():
        group, key = path.split(".")
        cfg[group][key] = value
    for key, value in SMALL_TRAFFIC.get(_traffic_name(name), {}).items():
        cell.traffic["params"][key] = value
    return cell


def _traffic_name(cell):
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    return {w["name"]: w["traffic"] for w in bench["workloads"]}[cell]


def run_small(name, seconds=0.5, trace=False, seed=2**33 + 17, **extra):
    """One run of a small cell on the CPU (the caller sets
    KMER_TPU_PLATFORM=cpu): the result line's object."""
    cell = small_cell(name, **extra)
    with tempfile.TemporaryDirectory() as wd:
        return harness.run_cell(cell, seed, seconds, trace, 0.0, wd,
                                require_cuda=False)
