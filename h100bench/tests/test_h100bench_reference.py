"""The plain reference against kmer_tpu_torch on the CPU, on tiny
inputs of each tool, and against a loop over the windows."""

import ast
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from h100bench import gen
from h100bench.reference import kmers, snp
from h100bench.tests.helpers import small_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")


def _tool(name, argv):
    from kmer_tpu_torch.tools import get_tool

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = get_tool(name)(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue()


def _loop_keys(reads, k):
    """Canonical codes of every window without N, one at a time."""
    out = []
    for r in reads.tolist():
        for i in range(len(r) - k + 1):
            w = r[i:i + k]
            if max(w) > 3:
                continue
            f = 0
            b = 0
            for j, c in enumerate(w):
                f = f * 4 + c
                b += (3 - c) * 4 ** j
            out.append(min(f, b))
    return sorted(out)


@pytest.mark.parametrize("k", [1, 5, 21, 31])
def test_window_keys_equal_a_loop(k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, (30, 40), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.02] = 4
    got = sorted(kmers.window_keys(torch.from_numpy(reads), k).tolist())
    assert got == _loop_keys(reads, k)


@pytest.mark.parametrize("k", [15, 31])
def test_kc_c4_rows_equal_the_port(tmp_path, k):
    c = small_cell("mabs_kc_c4")
    c.config["k"] = k
    inputs = gen.make_inputs(c.config, 2**32 + 3, str(tmp_path), 0)
    f = inputs.files[0]
    _, counts = kmers.key_counts(kmers.reads_keys(f.reads, k, CPU))
    want = kmers.hist_rows(counts, 256)
    assert want.count("\n") == 255 and counts.shape[0] > 1000
    assert _tool("kc-c4", [f"-k{k}", f.path]) == want


def test_kc_c4_rows_on_repeats(tmp_path):
    """Counts past 255 go to the last row, as the tool prints them."""
    c = small_cell("mabs_kc_c4", **{"genome.bases": 300,
                                    "reads.count": 2000})
    inputs = gen.make_inputs(c.config, 9, str(tmp_path), 0)
    f = inputs.files[0]
    _, counts = kmers.key_counts(kmers.reads_keys(f.reads, 31, CPU))
    assert int(counts.max()) > 255
    assert _tool("kc-c4", ["-k31", f.path]) == kmers.hist_rows(counts, 256)


def test_snp_files_equal_the_port(tmp_path):
    c = small_cell("ngscm_vaf")
    inputs = gen.make_inputs(c.config, 2**31 + 1, str(tmp_path), 0)
    ex, k = inputs.extra, c.config["k"]
    pat = str(tmp_path / "p.pat")
    _tool("snp-pattern-gen", [f"-k{k}", "-b", ex["bed"], "-f", ex["fasta"],
                              "-o", pat])
    rows = snp.patterns(ex, k, CPU)
    assert len(rows) > 250
    assert open(pat).read() == snp.pattern_text(ex, rows)
    for i in (0, 1):
        out = str(tmp_path / f"s{i}.vaf")
        _tool("vaf-counter", [f"-k{k}", "-p", pat, "-o", out,
                              inputs.files[i].path])
        want = snp.vaf_text(ex, rows, inputs.files[i].reads, k, CPU)
        assert open(out).read() == want


def test_first_pattern_owns_a_shared_kmer():
    rows = [(0, "", "", 5, 9), (1, "", "", 9, 7), (2, "", "", 5, 8)]
    codes, slot = snp.owners(rows)
    assert dict(zip(codes.tolist(), slot.tolist())) == \
        {5: 0, 9: 1, 7: 3, 8: 5}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "checks"])
def test_reference_imports_nothing_of_the_port(sub):
    here = os.path.join(os.path.dirname(os.path.dirname(__file__)), sub)
    for fn in os.listdir(here):
        if fn.endswith(".py"):
            tops = {m.split(".")[0]
                    for m in _imports(os.path.join(here, fn))}
            assert tops <= {"numpy", "torch", "h100bench", "__future__",
                            "typing"}, (fn, tops)


def _yak_loop(reads, k, pre, bf_shift, n_hash, chunk):
    """The bloom gate lane by lane, as yak-count.c inserts: the running
    number of admitted distinct k-mers after each batch."""
    from h100bench.reference import yak

    keys = kmers.window_keys(torch.from_numpy(reads), k)
    h = yak.hash64(keys, k)
    bits = [b.tolist() for b in yak.probe_bits(h, pre, bf_shift, n_hash)]
    h = h.tolist()
    sizes = yak.batches(reads, k, chunk, CPU)
    bloom, table, out, lane = set(), set(), [], 0
    for _n, n_lanes in sizes:
        for i in range(lane, lane + n_lanes):
            probe = [b[i] for b in bits]
            if all(p in bloom for p in probe):
                table.add(h[i])
            bloom.update(probe)
        lane += n_lanes
        out.append(len(table))
    return out


def test_yak_admission_equals_a_lane_loop():
    from h100bench.reference import yak

    c = small_cell("mabs_kc_c4", **{"genome.bases": 5_000,
                                    "reads.count": 600})
    genome = gen.genome_codes((4, 1), 5_000, 0.5)
    reads = gen.sample_reads(gen.device_rng("cpu", 4, 2), genome, 600, 60,
                             0.01, 0.001, 0.5).numpy()
    text = yak.expected(reads, 21, 10, 19, 4, 3000, CPU)
    got = [int(line.split("; ")[1].split()[0])
           for line in text.splitlines() if line.startswith("[M] ")]
    want = _yak_loop(reads, 21, 10, 19, 4, 3000)
    assert got[:len(want)] == want and got[len(want):] == \
        [want[-1]] * len(want)
    assert want[-1] > 0 and c is not None


@pytest.mark.parametrize("k, b", [(31, 19), (21, 20)])
def test_yak_rows_and_lines_equal_the_port(tmp_path, k, b):
    from h100bench.reference import yak

    c = small_cell("mabs_kc_c4", **{"genome.bases": 40_000,
                                    "reads.count": 6_000})
    inputs = gen.make_inputs(c.config, 2**32 + 7, str(tmp_path), 0)
    f = inputs.files[0]
    argv = [f"-k{k}", "-p10", f"-b{b}", "-H4", "-K100000", f.path]
    from kmer_tpu_torch.tools import get_tool

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert get_tool("yak-count")(argv) == 0
    got = out.getvalue() + "".join(
        line + "\n" for line in err.getvalue().splitlines()
        if line.startswith("[M"))
    want = yak.expected(f.reads, k, 10, b, 4, 100_000, CPU)
    assert want.count("[M] ") == 2 * 6 and "\t" in want
    lines = want.splitlines()
    total = int(lines[-2].split("; ")[1].split()[0])
    kept = int(lines[-1].split()[1])
    assert total > kept  # some singletons passed the bloom: its FPs
    assert got == want
