"""yak-count on the port's mesh (kmer_tpu_torch.pipeline.yak_admit
`ShardedDeferredYak`, pipeline.yak `MeshSortYakEngine` and
`make_yak_engine`, tools.yak_count's mesh gate) against the JAX
package's mesh on the CPU: JAX on its eight virtual CPU devices, the port
on a mesh of eight CPU entries.  Inputs are the fixtures or made with
numpy from a seed; the histograms, totals and `[M` lines are integers or
text, so every comparison is exact (tolerance 0)."""

import gzip
import os

import numpy as np
import pytest
import torch

from kmer_tpu.pipeline import yak as jyak
from kmer_tpu_torch.dist import sharded
from kmer_tpu_torch.kernels import keys as keys_mod
from kmer_tpu_torch.pipeline import yak, yak_admit

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
A = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def cpu_mesh(monkeypatch):
    """The port on the CPU, its default mesh eight CPU entries; one
    intra-op thread (many small blocks, six test workers)."""
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(sharded, "default_devices", lambda: list(CPU8))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    """Two gzipped FASTA files of 120 bp reads drawn from one random
    genome (so file 2 shares k-mers with file 1, and each step of file 1
    brings new ones), a tenth of them repeats: multi-occurrence keys,
    three mesh steps a file (19 rows of 65,536 bases)."""
    d = tmp_path_factory.mktemp("meshyak")
    rng = np.random.default_rng(5)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 400000)
    paths = []
    for name in ("f1", "f2"):
        p = str(d / f"{name}.fa.gz")
        with gzip.open(p, "wb") as f:
            for i in range(10000):
                if rng.random() < 0.1:
                    s = b"ACGT" * 30
                else:
                    o = int(rng.integers(0, genome.shape[0] - 120))
                    s = genome[o:o + 120].tobytes()
                f.write(b">r%d\n%s\n" % (i, s))
        paths.append(p)
    return paths


def _run(mod, paths, **kw):
    logs = []
    eng = mod.yak_count_file(paths[0], paths[1], mod.MeshSortYakEngine(
        log=lambda n, t: logs.append((n, t)), **kw))
    return eng, logs


@pytest.mark.parametrize("bf_shift", [19, 14, 0])
def test_mesh_yak_engine_matches_jax(bf_shift, two_files):
    """MeshSortYakEngine against JAX's on the two-file flow: histogram,
    tot and every logged (n_seqs, tot), over several steps.  bf 19: the
    bloom gates pass 1 (per-shard deferred admission with each shard's
    own step bounds); bf 14: its geometry disables it; bf 0: no pass 2,
    the histogram is pass 1's counts."""
    kw = dict(k=21, pre=10, bf_shift=bf_shift, bf_n_hash=4,
              chunk_size=1 << 17)
    je, jlogs = _run(jyak, two_files, **kw)
    te, tlogs = _run(yak, two_files, **kw)
    assert tlogs == jlogs
    assert len(jlogs) == (6 if bf_shift else 3)
    assert te.tot == je.tot > 0
    assert np.array_equal(te.hist(), np.asarray(je.hist()))
    # pass 1's per-step totals rise over several steps
    p1 = [t for _n, t in tlogs[:len(tlogs) // (2 if bf_shift else 1)]]
    assert len(set(p1)) > 1


def test_mesh_yak_equals_single_engine_histogram(two_files):
    """The bloom is partitioned by owner, so the mesh admits the keys the
    single engine's sequential bloom admits: same histogram and tot
    (the `[M` lines follow each engine's own steps)."""
    kw = dict(k=21, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=1 << 17)
    te, _ = _run(yak, two_files, **kw)
    se = yak.yak_count_file(two_files[0], two_files[1],
                            yak.SortYakEngine(device="cpu", **kw))
    assert te.tot == se.tot
    assert np.array_equal(te.hist(), se.hist())


def test_p_below_owner_bits_matches_jax(two_files, capsys):
    """-p below the mesh's owner bits: the bloom is disabled with JAX's
    warning, byte for byte, and the result equals JAX's."""
    kw = dict(k=21, pre=2, bf_shift=14, bf_n_hash=4, chunk_size=1 << 17)
    je, jlogs = _run(jyak, two_files, **kw)
    jerr = capsys.readouterr().err
    te, tlogs = _run(yak, two_files, **kw)
    terr = capsys.readouterr().err
    assert "-p2 has fewer prefix bits than the 8-device mesh needs (3)" \
        in terr
    assert terr == jerr and not te.use_bloom
    assert tlogs == jlogs and te.tot == je.tot
    assert np.array_equal(te.hist(), np.asarray(je.hist()))


def test_clamp_and_geometry_gates_match_jax(capsys):
    """The owner_bits clamp of a large -b and the geometry gate on the
    mesh: the same spec and warnings as JAX's engine."""
    for bf, pre in ((40, 10), (33, 25)):
        kw = dict(k=31, pre=pre, bf_shift=bf, bf_n_hash=4)
        je = jyak.MeshSortYakEngine(**kw)
        jerr = capsys.readouterr().err
        te = yak.MeshSortYakEngine(**kw)
        assert capsys.readouterr().err == jerr
        assert (te.use_bloom, te.bf_shift) == (je.use_bloom, je.bf_shift)
        if te.use_bloom:
            assert tuple(te.spec) == tuple(je.spec)
            assert te.spec.owner_bits == 3


def test_empty_second_file_matches_jax(two_files, tmp_path):
    """An empty pass 2 joins against nothing: every pass-1 key counts 0
    and the histogram is empty, as in JAX's mesh (yak.py:904-907)."""
    empty = str(tmp_path / "empty.fa.gz")
    with gzip.open(empty, "wb"):
        pass
    kw = dict(k=21, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=1 << 17)
    je, jlogs = _run(jyak, [two_files[0], empty], **kw)
    te, tlogs = _run(yak, [two_files[0], empty], **kw)
    assert tlogs == jlogs and te.tot == je.tot == 0
    assert np.array_equal(te.hist(), np.asarray(je.hist()))


def test_sharded_admission_empty():
    """No chunk at all, or shards that own no key in a step: zero
    per-step counts (yak_admit.py:687-690), one per step."""
    mesh = sharded.make_mesh(CPU8[:4])
    adm = yak_admit.ShardedDeferredYak(mesh, None, False)
    keys, per_step, tot = adm.finish()
    assert len(keys) == 4 and per_step.shape == (0,) and tot == 0
    adm = yak_admit.ShardedDeferredYak(mesh, None, False)
    one = torch.tensor([5, 9, 5], dtype=torch.int64)
    empty = one[:0]
    adm.add_chunk([empty, one, empty, empty])
    adm.add_chunk([empty] * 4)
    adm.add_chunk([empty, one[:1], empty, empty])
    keys, per_step, tot = adm.finish()
    assert per_step.tolist() == [2, 0, 0] and tot == 2
    assert [int((k != keys_mod.SENT).sum()) for k in keys] == [0, 2, 0, 0]


def test_one_entry_mesh_equals_single_engine(two_files):
    """A 1-shard mesh: the histogram and tot of SortYakEngine."""
    kw = dict(k=21, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=1 << 16)
    te = yak.yak_count_file(two_files[0], two_files[1],
                            yak.MeshSortYakEngine(devices=["cpu"], **kw))
    se = yak.yak_count_file(two_files[0], two_files[1],
                            yak.SortYakEngine(device="cpu", **kw))
    assert te.tot == se.tot
    assert np.array_equal(te.hist(), se.hist())


# -- CLI ---------------------------------------------------------------------


def _yak_cli(pkg, args, capsys):
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("args", [
    ["-k21", "-b20", "-K65536", READS],
    ["-k31", "-b19", "-K65536", A, B],
    ["-k15", "-b19", A, B],
], ids=["one-file", "two-files", "two-files-k15"])
def test_yak_count_cli_mesh_matches_jax(args, capsys, monkeypatch):
    """yak-count under KMER_TPU_FORCE_MESH=1: stdout and the whole of
    stderr equal JAX's mesh run (one file: a single `[M` line for the
    pass, no admission simulation)."""
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    want = _yak_cli("kmer_tpu", args, capsys)
    got = _yak_cli("kmer_tpu_torch", args, capsys)
    assert got == want
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    if args[-1] == READS:
        assert want[2].count("[M] processed") == 1
