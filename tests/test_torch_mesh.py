"""The port's single-process mesh (kmer_tpu_torch.dist.sharded: `route`,
`all_to_all`, `ShardedSortEngine`; pipeline.counter `MeshSortCountEngine`,
`use_mesh`, `make_count_engine`) against the JAX package's mesh on the
CPU: the JAX side on its eight virtual CPU devices (tests/conftest.py),
the port on a mesh of eight CPU entries with the same (data, shard)
shape.  Inputs are the fixtures or made with numpy from a seed; every
output is an integer or text, so every comparison is exact (tolerance
0)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kmer_tpu.dist import sharded as jsharded
from kmer_tpu.kernels import u64 as U
from kmer_tpu.pipeline import counter as jcounter
from kmer_tpu_torch.dist import sharded
from kmer_tpu_torch.kernels import extract
from kmer_tpu_torch.kernels import keys as tkeys
from kmer_tpu_torch.pipeline import counter

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
A = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")
CPU8 = [torch.device("cpu")] * 8
U32 = 0xFFFFFFFF


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


@pytest.fixture
def small_chunk(monkeypatch):
    """Stream ladders that merge at test sizes, in both packages."""
    monkeypatch.setattr(jsharded, "_MESH_STREAM_CHUNK", 1 << 11)
    monkeypatch.setattr(jsharded, "_MESH_STREAM_MIN", 1 << 8)
    monkeypatch.setattr(sharded, "_MESH_STREAM_CHUNK", 1 << 11)
    monkeypatch.setattr(sharded, "_MESH_STREAM_MIN", 1 << 8)


def _random_ascii(rng, n):
    return rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=n,
                      p=[0.24] * 4 + [0.005] * 4 + [0.02])


def _uniform_rows(rng, n_rows, width, read_len):
    """Rows of read_len-base reads, one NUL after each, whole reads only
    (the packer's uniform layout)."""
    rows = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (n_rows, width),
                      p=[0.2475] * 4 + [0.01])
    rows[:, read_len::read_len + 1] = 0
    rows[:, (width // (read_len + 1)) * (read_len + 1):] = 0
    return rows


def _meshes(shape):
    jm = jsharded.make_mesh(jax.devices()[:8], data=shape[0], shard=shape[1])
    return jm, sharded.make_mesh(CPU8, data=shape[0], shard=shape[1])


# -- routing ---------------------------------------------------------------


@pytest.mark.parametrize("k", [13, 21, 32])
def test_route_matches_jax_bucketize(k):
    """Each owner gets JAX `_bucketize_by_sort`'s keys in its order (its
    sentinel padding dropped): one-plane (k = 13) and two-plane keys,
    invalid lanes, and k = 32, where every key is hash64(0) and one owner
    takes every lane.  The owner bit of the biased int64 layout is the
    JAX package's lo-plane bit."""
    rng = np.random.default_rng(k)
    n, n_dest = 5000, 8
    if k == 32:
        raw = np.full(n, 0x77CFA1EEF01BCA90, np.uint64)
    else:
        raw = rng.integers(0, 1 << (2 * k), n, dtype=np.uint64)
    valid = rng.random(n) > 0.1
    raw[~valid] = np.uint64((1 << 64) - 1)
    hi = (raw >> np.uint64(32)).astype(np.uint32)
    lo = (raw & np.uint64(U32)).astype(np.uint32)
    j_hi, j_lo, n_drop = jsharded._bucketize_by_sort(
        U.U64(jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(valid),
        jnp.asarray((lo & (n_dest - 1)).astype(np.int32)), n_dest, n,
        one_plane=2 * k <= 31)
    assert int(n_drop) == 0
    got = sharded.route(torch.from_numpy(tkeys.from_u64(raw)), n_dest)
    assert len(got) == n_dest
    for j in range(n_dest):
        jh, jl = np.asarray(j_hi[j]), np.asarray(j_lo[j])
        keep = ~((jh == U32) & (jl == U32))
        gh, gl = tkeys.to_hi_lo(got[j])
        assert np.array_equal(gh, jh[keep]) and np.array_equal(gl, jl[keep])
    if k == 32:
        owner = 0x77CFA1EEF01BCA90 & 7
        assert [len(b) for b in got] == [
            int(valid.sum()) if j == owner else 0 for j in range(n_dest)]


def test_all_to_all_keeps_source_order():
    """Owner j receives every source row's bucket j in source order: the
    same lanes, in the same order, as one stable route of the rows laid
    end to end (the global stream restricted to j's keys)."""
    rng = np.random.default_rng(3)
    rows = [torch.from_numpy(tkeys.from_u64(
        rng.integers(0, 1 << 20, int(rng.integers(0, 900)),
                     dtype=np.uint64))) for _ in range(4)]
    mesh = sharded.make_mesh(CPU8[:4])
    got = sharded.all_to_all([sharded.route(r, 4) for r in rows], mesh)
    want = sharded.route(torch.cat(rows), 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sum(len(g) for g in got) == sum(len(r) for r in rows)
    batched = sharded.all_to_all(sharded.route_rows(rows, 4), mesh)
    assert all(torch.equal(g, w) for g, w in zip(batched, want))


def test_kernel_launch_makes_the_tensors_device_current(monkeypatch):
    """A shard's kernels launch with its own card current and into that
    card's stream (CUDA refuses a launch into another device's stream,
    and the mesh puts shard j on cuda:j): every wrapper launches through
    _build.launch, checked here with a stand-in library."""
    from kmer_tpu_torch.kernels import _build

    seen = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen.append(("enter", self.dev))

        def __exit__(self, *exc):
            seen.append(("exit", self.dev))

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    class Lib:
        def ktt_probe(self, *args):
            seen.append(("call", args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setitem(_build.LAUNCHES, "extract", 5)
    dev = torch.device("cuda", 3)
    _build.launch("ktt_probe", "extract", SimpleNamespace(device=dev), 7, 8)
    assert seen == [("enter", dev), ("call", (7, 8, 1003)), ("exit", dev)]
    assert _build.LAUNCHES["extract"] == 6


def test_make_mesh_factorization():
    """JAX's most-square (data, shard) factorization, data-major order."""
    for n in (1, 2, 4, 8):
        jm = jsharded.make_mesh(jax.devices()[:n])
        tm = sharded.make_mesh(CPU8[:n])
        assert (tm.shape["data"], tm.shape["shard"]) == (
            jm.shape["data"], jm.shape["shard"])
    assert sharded.make_mesh().size == 8  # the patched default list


# -- ShardedSortEngine -----------------------------------------------------

# (shape, k, the JAX engine's stream_sorted, budget_bytes, row layout)
ENGINE_CASES = [
    ((2, 4), 21, False, 2 << 30, "ragged"),
    ((1, 8), 21, True, 2 << 30, "ragged"),
    ((4, 2), 13, True, 1, "ragged"),
    ((2, 4), 13, False, 2 << 30, "uniform"),
    ((2, 4), 31, True, 2 << 30, "uniform"),
    ((1, 8), 31, False, 1, "uniform"),
    ((4, 2), 32, True, 2 << 30, "ragged"),
    ((2, 4), 32, False, 1, "uniform"),
]


@pytest.mark.parametrize("shape,k,stream,budget,layout", ENGINE_CASES)
def test_sharded_engine_matches_jax(shape, k, stream, budget, layout,
                                    small_chunk):
    """hist, _n_distinct and total_kmers against JAX ShardedSortEngine
    over three batches (a repeated one, so keys recur across batches and
    rows; the last short: JAX pads it with zero rows, the port sends
    fewer rows), the JAX engine in stream mode and classic, budget 1 (a
    trip every batch), uniform rows (row_bytes) and ragged ones."""
    rng = np.random.default_rng(k * 7 + shape[0])
    width, rb = 4096, 101
    make = ((lambda n: _uniform_rows(rng, n, width, rb - 1))
            if layout == "uniform"
            else (lambda n: np.stack([_random_ascii(rng, width)
                                      for _ in range(n)])))
    b1 = make(8)
    batches = [b1, make(8), np.concatenate([b1[:5]])]
    row_bytes = rb if layout == "uniform" else None
    jm, tm = _meshes(shape)
    je = jsharded.ShardedSortEngine(jm, k, budget_bytes=budget,
                                    stream_sorted=stream)
    te = sharded.ShardedSortEngine(tm, k, budget_bytes=budget)
    for b in batches:
        padded = np.zeros((8, width), np.uint8)
        padded[:b.shape[0]] = b
        je.add_batch(jnp.asarray(padded), row_bytes=row_bytes)
        te.add_batch(torch.from_numpy(b), row_bytes=row_bytes)
    want = je.hist(256, max_count=1023)
    got = te.hist(256, max_count=1023)
    assert np.array_equal(got, np.asarray(want))
    assert te._n_distinct == je._n_distinct > 0
    assert te.total_kmers == je.total_kmers
    if budget == 1:
        assert all(c.runs and c.runs[0][1] is not None for c in te.shards
                   if c.runs or c.stream)
    # yak-count's bins and min_keep on the same state
    assert np.array_equal(te.hist(1024, max_count=1023, min_keep=2),
                          np.asarray(je.hist(1024, max_count=1023,
                                             min_keep=2)))
    assert te._n_distinct == je._n_distinct


def test_sharded_engine_empty():
    """No input: a zero histogram, _n_distinct 0 (sharded.py:817-820)."""
    jm, tm = _meshes((2, 4))
    je, te = jsharded.ShardedSortEngine(jm, 21), sharded.ShardedSortEngine(
        tm, 21)
    assert np.array_equal(te.hist(256), np.asarray(je.hist(256)))
    assert te._n_distinct == je._n_distinct == 0
    q = np.arange(5, dtype=np.uint32)
    assert np.array_equal(te.counts_for(q, q), je.counts_for(q, q))


# -- counts_for ------------------------------------------------------------


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("k", [13, 21])
def test_counts_for_matches_jax(k, stream, small_chunk):
    """The sum of the shards' answers equals JAX's mesh `counts_for`
    (replicated queries + psum), the JAX engine in stream mode and
    classic: after two batches, after a compact, and in the mixed state
    of a compact and one more batch; present, absent and repeated query
    keys."""
    rng = np.random.default_rng(40 + k)
    rows = np.stack([_random_ascii(rng, 4096) for _ in range(8)])
    jm, tm = _meshes((2, 4))
    je = jsharded.ShardedSortEngine(jm, k, stream_sorted=stream)
    te = sharded.ShardedSortEngine(tm, k)
    keys = np.concatenate([
        tkeys.to_u64(extract.extract_keys_plain(
            torch.from_numpy(r), k)[0].numpy()) for r in rows[:2]])
    keys = keys[keys != np.uint64((1 << 64) - 1)]
    q = np.concatenate([keys[:60], keys[:10],
                        rng.integers(0, 1 << (2 * k), 20, dtype=np.uint64)])
    qhi = (q >> np.uint64(32)).astype(np.uint32)
    qlo = (q & np.uint64(U32)).astype(np.uint32)

    def check():
        want = je.counts_for(qhi, qlo)
        got = te.counts_for(qhi, qlo)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert want[:60].min() > 0

    for b in (rows, rows[::-1].copy()):
        je.add_batch(jnp.asarray(b))
        te.add_batch(torch.from_numpy(b))
    check()
    je.compact()
    te.compact()
    check()
    je.add_batch(jnp.asarray(rows))
    te.add_batch(torch.from_numpy(rows))
    check()


# -- MeshSortCountEngine ---------------------------------------------------


@pytest.fixture
def clean_reads(tmp_path_factory):
    """A gzipped FASTQ of uniform 150 bp reads with no N (packed ingest
    then elides every mask: the structural step)."""
    import gzip

    path = str(tmp_path_factory.mktemp("mesh") / "clean.fq.gz")
    rng = np.random.default_rng(8)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 40000)
    with gzip.open(path, "wb") as f:
        for i in range(4000):
            s = int(rng.integers(0, genome.shape[0] - 150))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, genome[s:s + 150].tobytes(),
                                           b"I" * 150))
    return path


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("which", ["fixtures", "clean"])
def test_mesh_count_engine_matches_jax(packed, which, clean_reads,
                                       monkeypatch):
    """MeshSortCountEngine's hist, _n_distinct and totals against JAX's,
    with KMER_TPU_PACKED=1 off and on: the fixtures (N bases and varied
    lengths: masked steps) and uniform clean reads (structural steps),
    several steps of eight rows, the last one short."""
    if packed and not counter.native_reader():
        pytest.skip("packed ingest needs the native reader")
    monkeypatch.setenv("KMER_TPU_PACKED", "1" if packed else "0")
    paths = [READS, A] if which == "fixtures" else [clean_reads]
    k = 21 if which == "fixtures" else 31
    je = jcounter.MeshSortCountEngine(k, block_bases=1 << 17)
    je.count_paths(paths)
    te = counter.MeshSortCountEngine(k, block_bases=1 << 17)
    seen = []
    te.count_paths(paths, progress=lambda e: seen.append(e.total_bases))
    want = je.hist(256, max_count=1023)
    assert np.array_equal(te.hist(256, max_count=1023), np.asarray(want))
    assert te._n_distinct == je._n_distinct
    assert (te.total_bases, te.total_seqs, te.total_kmers) == (
        je.total_bases, je.total_seqs, je.total_kmers)
    assert len(seen) > 1 and seen[-1] == te.total_bases
    assert te.eng.shards[0].device == torch.device("cpu")


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_mesh_checkpoint_both_ways(saver, tmp_path):
    """One package saves after file A, the other resumes and counts file
    B: the histogram and totals equal an uninterrupted run
    (tests/test_checkpoint.py:66-93 across the packages)."""
    ck = str(tmp_path / "mesh.ckpt.npz")
    pkgs = {"port": counter, "jax": jcounter}
    loader = "jax" if saver == "port" else "port"
    e1 = pkgs[saver].MeshSortCountEngine(k=21, block_bases=1 << 17)
    e1.count_paths([A])
    e1.save_checkpoint(ck)
    z = np.load(ck)
    assert z["hi"].shape[:2] == (2, 4) and z["hi"].dtype == np.uint32
    assert z["cnt"].dtype == np.uint32 and z["meta"][0] == 21
    e2 = pkgs[loader].MeshSortCountEngine(k=21, block_bases=1 << 17)
    e2.resume_checkpoint_into(ck)
    e2.count_paths([B])
    full = jcounter.MeshSortCountEngine(k=21, block_bases=1 << 17)
    full.count_paths([A, B])
    want = np.asarray(full.hist(256, max_count=1023))
    assert np.array_equal(np.asarray(e2.hist(256, max_count=1023)), want)
    assert e2._n_distinct == full._n_distinct
    assert (e2.total_bases, e2.total_seqs, e2.total_kmers) == (
        full.total_bases, full.total_seqs, full.total_kmers)


def test_checkpoint_layout_and_empty(tmp_path):
    """The port's file: sentinel tails at count 0, L the JAX size class
    of the largest shard; an engine that saw nothing writes (2, 4, 1)
    sentinels, as JAX does, and both restore it to an empty count."""
    te = counter.MeshSortCountEngine(k=15, block_bases=1 << 17)
    te.count_paths([READS])
    ck = str(tmp_path / "c.npz")
    te.save_checkpoint(ck)
    z = np.load(ck)
    runs = [c.runs[0][0].shape[0] for c in te.eng.shards]
    assert z["hi"].shape == (2, 4, max(1 << 16, 1 << (max(runs) - 1)
                                       .bit_length()))
    real = ~((z["hi"] == U32) & (z["lo"] == U32))
    assert real.sum(axis=2).ravel().tolist() == runs
    assert not z["cnt"][~real].any()
    empty = str(tmp_path / "e.npz")
    jm, tm = _meshes((2, 4))
    sharded.ShardedSortEngine(tm, 21).save_checkpoint(empty)
    jsharded.ShardedSortEngine(jm, 21).save_checkpoint(empty + ".j.npz")
    for path in (empty, empty + ".j.npz"):
        z = np.load(path)
        assert z["hi"].shape == (2, 4, 1) and (z["hi"] == U32).all()
        te = sharded.ShardedSortEngine(tm, 21)
        te.restore_checkpoint(path)
        assert not te.hist(256).any() and te._n_distinct == 0


# -- factories, the 1-entry mesh -----------------------------------------


def test_factory_gate(monkeypatch):
    """KMER_TPU_FORCE_MESH picks the engines: 1 (true, on, yes) the mesh
    ones, 0 (false, off, no) and, on the CPU, unset the single ones."""
    from kmer_tpu_torch.pipeline import yak

    for value, mesh in (("1", True), ("on", True), ("YES", True),
                        ("0", False), ("off", False), ("", False)):
        monkeypatch.setenv("KMER_TPU_FORCE_MESH", value)
        assert counter.use_mesh() is mesh
        eng = counter.make_count_engine(21)
        assert isinstance(eng, counter.MeshSortCountEngine if mesh
                          else counter.SortCountEngine)
        y = yak.make_yak_engine(k=21, bf_shift=19)
        assert isinstance(y, yak.MeshSortYakEngine if mesh
                          else yak.SortYakEngine)
        if mesh:
            assert eng.n_dev == y.n_dev == 8


def test_one_entry_mesh_equals_single_engine():
    """A 1-shard mesh counts what SortCountEngine counts."""
    te = counter.MeshSortCountEngine(31, block_bases=1 << 16,
                                     devices=["cpu"])
    te.count_paths([READS, A])
    se = counter.SortCountEngine(31, block_bases=1 << 16, device="cpu")
    se.count_paths([READS, A])
    assert np.array_equal(te.hist(256), se.hist(256))
    assert (te._n_distinct, te.total_kmers, te.total_bases,
            te.total_seqs) == (se._n_distinct, se.total_kmers,
                               se.total_bases, se.total_seqs)


# -- CLI ---------------------------------------------------------------------


def _tool(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.tools").get_tool(name)


@pytest.mark.parametrize("k", [21, 31, 32])
def test_kc_c4_cli_mesh_matches_jax(k, capsys, monkeypatch):
    """kc-c4 under KMER_TPU_FORCE_MESH=1: the port's eight-entry mesh
    prints JAX's eight-device mesh's bytes (and the single engine's)."""
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    args = [f"-k{k}", READS]
    assert _tool("kmer_tpu", "kc-c4")(args) == 0
    want = capsys.readouterr().out
    assert _tool("kmer_tpu_torch", "kc-c4")(args) == 0
    assert capsys.readouterr().out == want
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "0")
    assert _tool("kmer_tpu_torch", "kc-c4")(args) == 0
    assert capsys.readouterr().out == want


def test_vaf_counter_cli_mesh_matches_jax(tmp_path, capsys, monkeypatch):
    """vaf-counter -v on the sample fixtures under KMER_TPU_FORCE_MESH=1:
    the VAF file equals JAX's mesh run's, and its -v report names the
    same sequence, base and k-mer totals."""
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    pat = str(tmp_path / "p.pat")
    assert _tool("kmer_tpu", "snp-pattern-gen")(
        ["-k21", "-b", os.path.join(FIXTURES, "snps_small.bed"), "-f",
         os.path.join(FIXTURES, "genome_small.fa.gz"), "-o", pat]) == 0
    samples = [os.path.join(FIXTURES, f"sample{s}.fq.gz")
               for s in ("A1", "A2", "B")]
    reports = {}
    for pkg in ("kmer_tpu", "kmer_tpu_torch"):
        out = str(tmp_path / f"{pkg}.vaf")
        capsys.readouterr()
        assert _tool(pkg, "vaf-counter")(
            ["-k21", "-v", "-p", pat, "-o", out] + samples) == 0
        err = capsys.readouterr().err
        reports[pkg] = [ln for ln in err.splitlines()
                        if ln.strip().startswith((
                            "Sequences processed", "Bases processed",
                            "K-mers extracted"))]
    with open(tmp_path / "kmer_tpu.vaf") as f, \
            open(tmp_path / "kmer_tpu_torch.vaf") as g:
        want, got = f.read(), g.read()
    assert got == want and len(want.splitlines()) > 10
    assert reports["kmer_tpu"] == reports["kmer_tpu_torch"]
    assert len(reports["kmer_tpu"]) == 3
