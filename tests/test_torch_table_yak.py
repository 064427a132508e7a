"""The port's open-addressing yak engines (kmer_tpu_torch.pipeline.yak
`YakEngine`, `MeshYakEngine`, `make_yak_engine` under
KMER_TPU_TABLE_YAK=1; the per-shard table helpers and the table-based
kc step of kmer_tpu_torch.dist.sharded) against the JAX package's on the
CPU, and the KMER_TPU_PROFILE switch.

Inputs are the fixtures, or gzipped reads made with numpy from a seed;
the same inputs go to both packages.  Histograms, totals, `[M` lines and
table planes are integers or text: every comparison is exact (tolerance
0).  The mesh runs on eight CPU shards against JAX's eight virtual
devices; the two-process run uses tests/test_torch_multiprocess.py's
gloo workers."""

import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.dist import sharded as jsharded
from kmer_tpu.pipeline import yak as jyak
from kmer_tpu_torch.dist import sharded
from kmer_tpu_torch.pipeline import yak
from kmer_tpu_torch.table import count_table as ct

from test_torch_multiprocess import run_workers

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    """The port on the CPU, its default mesh eight CPU entries, one
    intra-op thread (six test workers share the cores)."""
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(sharded, "default_devices", lambda: list(CPU8))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """Two gzipped FASTA files of 100 bp reads from one random genome
    (file 2 shares k-mers with file 1), a tenth of them one repeat:
    several batches at chunk_size 2^14."""
    d = tmp_path_factory.mktemp("tableyak")
    rng = np.random.default_rng(7)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60000)
    paths = []
    for name in ("s1", "s2"):
        p = str(d / f"{name}.fa.gz")
        with gzip.open(p, "wb") as f:
            for i in range(600):
                if rng.random() < 0.1:
                    s = b"ACGT" * 25
                else:
                    o = int(rng.integers(0, genome.shape[0] - 100))
                    s = genome[o:o + 100].tobytes()
                f.write(b">r%d\n%s\n" % (i, s))
        paths.append(p)
    return paths


def _jax_planes(table):
    return [np.asarray(x) for x in (table.state, table.key_hi,
                                    table.key_lo, table.cnt)]


def _flow(mod, cls, paths, planes, **kw):
    """yak_count_file step by step: (every logged (n_seqs, tot), tot,
    hist, the table planes after pass 1 as planes(engine) gives them)."""
    logs = []
    eng = cls(log=lambda n, t: logs.append((n, t)), **kw)
    eng.count([paths[0]], create_new=True)
    after1 = planes(eng)
    if eng.bf_shift > 0:
        eng.destroy_bloom()
        eng.clear()
        eng.count([paths[1]], create_new=False)
        eng.shrink(2, mod.YAK_MAX_COUNT)
    return logs, eng.tot, np.asarray(eng.hist()).astype(np.int64), after1


def _same_planes(got, want):
    return len(got) == len(want) and all(
        np.array_equal(g, w) and g.dtype == w.dtype
        for g, w in zip(got, want))


@pytest.mark.parametrize("bf_shift", [19, 14, 0])
@pytest.mark.parametrize("inputs", ["fixtures", "seeded"])
def test_yak_engine_matches_jax(inputs, bf_shift, seeded):
    """YakEngine through the two-file flow: every `[M` (n_seqs, tot),
    tot, the histogram and the table planes after pass 1 equal JAX's.
    bf 19: the bloom gates pass 1 (tombstones, rebuilds); bf 14: its
    geometry disables it; bf 0: one pass, the histogram is its counts."""
    paths = [A1, B] if inputs == "fixtures" else seeded
    kw = dict(k=31 if inputs == "fixtures" else 21, pre=10,
              bf_shift=bf_shift, bf_n_hash=4, chunk_size=1 << 14)
    want = _flow(jyak, jyak.YakEngine, paths,
                 lambda e: _jax_planes(e.table), **kw)
    got = _flow(yak, yak.YakEngine, paths,
                lambda e: list(ct.to_jax_planes(e.table)), device="cpu",
                **kw)
    assert got[:2] == want[:2]
    assert np.array_equal(got[2], want[2])
    assert _same_planes(got[3], want[3])
    assert len(got[0]) > (4 if bf_shift else 2) and got[1] > 0


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each package's checkpoint after pass 1 of sampleA1 at -b19, and
    the JAX package's uninterrupted two-file result (hist, tot)."""
    d = tmp_path_factory.mktemp("tableyak_ckpt")
    kw = dict(k=21, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=1 << 14)
    paths = {"jax": str(d / "jax.ckpt.npz"), "port": str(d / "port.ckpt.npz")}
    e = jyak.YakEngine(**kw)
    e.count([A1], create_new=True)
    e.save_checkpoint(paths["jax"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        e = yak.YakEngine(device="cpu", **kw)
        e.count([A1], create_new=True)
        e.save_checkpoint(paths["port"])
    finally:
        torch.set_num_threads(n)
    full = jyak.yak_count_file(A1, B, jyak.YakEngine(**kw))
    return paths, np.asarray(full.hist()).astype(np.int64), full.tot


def _resume_pass2(cls, path, **kw):
    eng = cls.resume_checkpoint(path, **kw)
    eng.destroy_bloom()
    eng.clear()
    eng.count([B], create_new=False)
    eng.shrink(2, 1023)
    return np.asarray(eng.hist()).astype(np.int64), eng.tot


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_checkpoint_crosses_packages(saved_by, checkpoints):
    """A YakEngine checkpoint saved between the passes by either package
    resumes in the other (and in its own) to the uninterrupted run's
    histogram and tot; both packages write the same arrays."""
    paths, want_hist, want_tot = checkpoints
    zj, zp = np.load(paths["jax"]), np.load(paths["port"])
    assert sorted(zj.files) == sorted(zp.files) == sorted(
        ["state", "key_hi", "key_lo", "cnt", "bits", "meta"])
    for name in zj.files:
        assert zp[name].dtype == zj[name].dtype, name
        assert np.array_equal(zp[name], zj[name]), name
    assert zj["bits"].shape[0] == 1 << 19
    port = _resume_pass2(yak.YakEngine, paths[saved_by], device="cpu")
    jax_ = _resume_pass2(jyak.YakEngine, paths[saved_by])
    for hist, tot in (port, jax_):
        assert np.array_equal(hist, want_hist) and tot == want_tot > 0


def _tool(pkg, args, capsys):
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "mesh"])
def test_table_yak_cli_matches_jax(mesh, capsys, monkeypatch):
    """KMER_TPU_TABLE_YAK=1 yak-count A B: stdout and the whole of stderr
    equal JAX's, on one device (YakEngine) and on the mesh
    (MeshYakEngine, KMER_TPU_FORCE_MESH=1), and the tool took the table
    engine."""
    monkeypatch.setenv("KMER_TPU_TABLE_YAK", "1")
    if mesh:
        monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    args = ["-k21", "-b19", "-K65536", A1, B]
    want = _tool("kmer_tpu", args, capsys)
    made, real = [], yak.make_yak_engine

    def record(**kw):
        made.append(real(**kw))
        return made[-1]

    from kmer_tpu_torch.tools import yak_count

    monkeypatch.setattr(yak_count, "make_yak_engine", record)
    got = _tool("kmer_tpu_torch", args, capsys)
    assert got == want
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    assert type(made[0]) is (yak.MeshYakEngine if mesh else yak.YakEngine)


def test_make_yak_engine_reads_the_switch(monkeypatch):
    """The engine make_yak_engine picks, by KMER_TPU_TABLE_YAK and the
    mesh gate, as JAX's yak.py:1117-1131 picks it."""
    picks = {}
    for table in ("", "1", "0"):
        for mesh in ("0", "1"):
            monkeypatch.setenv("KMER_TPU_TABLE_YAK", table)
            monkeypatch.setenv("KMER_TPU_FORCE_MESH", mesh)
            picks[table, mesh] = type(yak.make_yak_engine(k=21)).__name__
    assert picks == {
        ("", "0"): "SortYakEngine", ("", "1"): "MeshSortYakEngine",
        ("1", "0"): "YakEngine", ("1", "1"): "MeshYakEngine",
        ("0", "0"): "SortYakEngine", ("0", "1"): "MeshSortYakEngine"}


@pytest.fixture(scope="module")
def mesh_files(tmp_path_factory):
    """Two gzipped FASTA files of 120 bp reads from one random genome, two
    mesh steps a file (eight rows of 65,536 bases a step)."""
    d = tmp_path_factory.mktemp("tablemesh")
    rng = np.random.default_rng(5)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 400000)
    paths = []
    for name in ("f1", "f2"):
        p = str(d / f"{name}.fa.gz")
        with gzip.open(p, "wb") as f:
            for i in range(6000):
                if rng.random() < 0.1:
                    s = b"ACGT" * 30
                else:
                    o = int(rng.integers(0, genome.shape[0] - 120))
                    s = genome[o:o + 120].tobytes()
                f.write(b">r%d\n%s\n" % (i, s))
        paths.append(p)
    return paths


def _jax_shard_planes(eng):
    """JAX's (data, shard, cap) planes as one list of planes a shard, in
    the port's shard order (data * S + shard)."""
    pl = [np.asarray(x) for x in eng.tables[:4]]
    return [[p[a, b] for p in pl] for a in range(pl[0].shape[0])
            for b in range(pl[0].shape[1])]


@pytest.mark.parametrize("bf_shift", [19, 0])
def test_mesh_yak_engine_matches_jax(bf_shift, mesh_files):
    """MeshYakEngine on eight CPU shards against JAX's on its eight
    virtual devices: `[M` lines, tot, histogram and every shard's table
    planes after pass 1 (ragged owner buckets against JAX's padded
    windows: the lane order and so every slot is the same)."""
    kw = dict(k=21, pre=10, bf_shift=bf_shift, bf_n_hash=4,
              chunk_size=1 << 17)
    want = _flow(jyak, jyak.MeshYakEngine, mesh_files, _jax_shard_planes,
                 **kw)
    got = _flow(yak, yak.MeshYakEngine, mesh_files,
                lambda e: [list(ct.to_jax_planes(t)) for t in e.tables],
                **kw)
    assert got[:2] == want[:2]
    assert np.array_equal(got[2], want[2])
    assert len(got[3]) == len(want[3]) == 8
    for g, w in zip(got[3], want[3]):
        assert _same_planes(g, w)
    assert len(got[0]) == (4 if bf_shift else 2)


def test_sharded_count_step_matches_jax():
    """The table-based kc step on eight shards (two steps into the same
    tables) and the summed histogram equal JAX's sharded_count_step_fn
    and sharded_hist_fn, table planes shard by shard."""
    rng = np.random.default_rng(11)
    k, block, cap = 21, 4096, 8192
    steps = [rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8),
                        size=(8, block),
                        p=[0.24] * 4 + [0.005] * 4 + [0.02])
             for _ in range(2)]
    mesh = jsharded.make_mesh()
    jstep = jsharded.sharded_count_step_fn(mesh, k, max_count=1023,
                                           lanes_per_dest=2048)
    jt = jsharded.make_sharded_tables(mesh, cap)
    router = sharded.ShardedSortEngine(sharded.make_mesh(), k)
    tables = sharded.make_sharded_tables(router.mesh, cap)
    for rows in steps:
        jt, jn, jd = jstep(jt, jnp.asarray(rows))
        tables, n, d = sharded.sharded_count_step(
            router, tables, [torch.from_numpy(r) for r in rows], 1023)
        assert (n, d) == (int(jn), int(jd)) and n > 0
    want = np.asarray(jsharded.sharded_hist_fn(mesh, 256)(jt))
    got = sharded.sharded_table_hist(router.mesh, tables, 256)
    assert np.array_equal(got, want.astype(np.int64))
    pl = [np.asarray(x) for x in jt[:4]]
    for j, t in enumerate(tables):
        a, b = divmod(j, pl[0].shape[1])
        assert _same_planes(list(ct.to_jax_planes(t)),
                            [p[a, b] for p in pl])
    assert sharded.sharded_nfull_stats(router.mesh, tables)[1] == int(
        np.asarray(jt[4]).sum())


MP_TABLE_YAK = """
from kmer_tpu_torch.pipeline.yak import MeshYakEngine, yak_count_file

lines = []
eng = MeshYakEngine(k=21, pre=10, bf_shift=19, bf_n_hash=4,
                    chunk_size=65536,
                    log=lambda ns, tot: lines.append([ns, tot]))
yak_count_file(args[0], args[1], eng)
result.update(hist=eng.hist().tolist(), tot=eng.tot, yak=lines,
              cap=eng.cap_local)
"""


def test_two_processes_match_jax(tmp_path, mesh_files):
    """Two gloo processes of four CPU shards under KMER_TPU_SINGLE_READER=1
    run MeshYakEngine's two-file flow: hist, tot and every `[M` line
    equal JAX's one-process eight-device MeshYakEngine (the same steps,
    the same admission order), in both processes."""
    paths = mesh_files
    got = run_workers(tmp_path, MP_TABLE_YAK, paths,
                      env={"KMER_TPU_SINGLE_READER": "1"}, name="tyak")
    lines = []
    je = jyak.yak_count_file(paths[0], paths[1], jyak.MeshYakEngine(
        k=21, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=65536,
        log=lambda ns, tot: lines.append([ns, tot])))
    want = np.asarray(je.hist()).astype(np.int64)
    assert len(lines) > 2
    for g in got:
        assert np.array_equal(np.asarray(g["hist"]), want)
        assert g["tot"] == je.tot > 0 and g["yak"] == lines
        assert g["cap"] == je.cap_local


def test_profile_switch_writes_a_trace(tmp_path, monkeypatch, capsys):
    """KMER_TPU_PROFILE=<dir>: kc-c4 writes a torch.profiler trace into
    <dir> (one file a counting loop, on one device and on the mesh), and
    its histogram is unchanged."""
    from kmer_tpu_torch.tools import get_tool

    reads = os.path.join(FIXTURES, "reads_small.fq.gz")
    outs = []
    for env in ({}, {"KMER_TPU_PROFILE": str(tmp_path / "one")},
                {"KMER_TPU_PROFILE": str(tmp_path / "mesh"),
                 "KMER_TPU_FORCE_MESH": "1"}):
        with monkeypatch.context() as m:
            for name, v in env.items():
                m.setenv(name, v)
            assert get_tool("kc-c4")(["-k21", reads]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2] and len(outs[0].splitlines()) == 255
    for d in ("one", "mesh"):
        files = os.listdir(tmp_path / d)
        assert len(files) == 1 and files[0].endswith(".json")
        assert os.path.getsize(tmp_path / d / files[0]) > 0
