"""Packed 2-bit ingest of the port (kmer_tpu_torch.io.native's
iter_packed2bit_native, kmer_tpu_torch.pipeline.counter's _iter_packed2,
unpack functions and packed branch of the shared ingest loop) against
the JAX package on the CPU, and against the port's own ASCII path.

Inputs are the fixtures, or made with numpy from a seed; the same
inputs go to both packages.  Every output is an integer or a byte:
every comparison is exact (tolerance 0)."""

import gzip
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.io import native as jnative
from kmer_tpu.pipeline import counter as jc
from kmer_tpu_torch.io import native
from kmer_tpu_torch.pipeline import counter as tc
from kmer_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")


def _staged_bytes(eng, paths):
    """Count `paths` on `eng` with the tracer on: the bytes its
    `reader.stage` spans staged."""
    trace.clear()
    trace.enable(True)
    try:
        eng.count_paths(paths)
    finally:
        trace.enable(False)
    got = sum(s.attrs["bytes"] for s in trace.spans()
              if s.name == "reader.stage")
    trace.clear()
    return got


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small blocks: one intra-op thread keeps the
    torch side from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def need_native():
    if not (native.available() and jnative.available()):
        pytest.skip("the native reader does not build here (g++ or zlib)")


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert x == y


# -- the reader and the elision ------------------------------------------

@pytest.mark.parametrize("policy", [None, ("resume", 21, 3)],
                         ids=["stop", "resume"])
@pytest.mark.parametrize("path", [READS, A1, B],
                         ids=["reads_small", "sampleA1", "sampleB"])
def test_packed_reader_matches_jax(path, policy, need_native):
    """iter_packed2bit_native, buffer for buffer; an odd capacity is
    rounded up to a multiple of 8 in both."""
    args = ([path], 21, 30000, 30000 + 4093, policy)
    got = list(native.iter_packed2bit_native(*args))
    assert len(got) > 1 and got[0][0].shape[0] == (30000 + 4096) // 4
    _same(got, jnative.iter_packed2bit_native(*args))


def _uniform_fastq(path, n_reads, n_at=()):
    """150 bp reads from seed 3; read i in n_at gets an N at base 60."""
    rng = np.random.default_rng(3)
    with gzip.open(path, "wb") as f:
        for i in range(n_reads):
            s = rng.choice(list(b"ACGT"), 150).astype(np.uint8)
            if i in n_at:
                s[60] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 150))


@pytest.fixture(scope="module")
def uniform(tmp_path_factory):
    """A clean uniform FASTQ and the same reads with one N in the third
    of its five 2^16-base blocks."""
    d = tmp_path_factory.mktemp("uniform")
    clean, dirty = str(d / "clean.fq.gz"), str(d / "dirty.fq.gz")
    _uniform_fastq(clean, 2000)
    _uniform_fastq(dirty, 2000, n_at=(1000,))
    return clean, dirty


def test_mask_elision_block_by_block(uniform, need_native):
    """The mask is elided on every block of the clean file and on every
    block but the one with the N of the other, exactly where JAX elides
    it, and the trimmed buffers are equal."""
    clean, dirty = uniform
    args = (31, 1 << 16, (1 << 16) + 4096, None)
    for path, want_elided in ((clean, [True] * 5),
                              (dirty, [True, True, False, True, True])):
        got = list(tc._iter_packed2([path], *args))
        want = list(jc._iter_packed2([path], *args))
        assert [m is None for _, m, *_ in got] == want_elided
        assert [m is None for _, m, *_ in want] == want_elided
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0])
            assert (g[1] is None) == (w[1] is None)
            if g[1] is not None:
                assert np.array_equal(g[1], w[1])
            assert g[2:] == w[2:]


# -- the unpack ----------------------------------------------------------

# the three size classes and an untrimmed capacity (2^16-base blocks),
# in codes
SIZES = [1 << 16, 1 << 20, 1 << 23, (1 << 16) + 4096]


@pytest.mark.parametrize("n", SIZES)
def test_unpack_ascii_matches_jax(n):
    rng = np.random.default_rng(n % 1000)
    packed = rng.integers(0, 256, n // 4, dtype=np.uint8)
    mask = (rng.random(n // 8) < 0.3) * rng.integers(0, 256, n // 8)
    mask = mask.astype(np.uint8)
    want = np.asarray(jc._unpack_ascii(jnp.asarray(packed),
                                       jnp.asarray(mask)))
    got = tc._unpack_ascii(torch.from_numpy(packed), torch.from_numpy(mask))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0, 65, 67, 71, 84}


@pytest.mark.parametrize("n,row_bytes,used", [
    (n, 151, "mid_row") for n in SIZES] + [
    (1 << 16, 151, "row_end"), (1 << 20, 151, "in_tail"),
    (1 << 23, 151, "all"), (1 << 16, 128, "mid_row"),
    (1 << 20, 32, "all")])
def test_structural_ascii_matches_jax(n, row_bytes, used):
    """span = whole rows != n (151), span == n (128, 32); n_used in the
    middle of a row, at a row's end, past the last whole row, and n."""
    rng = np.random.default_rng(row_bytes)
    packed = rng.integers(0, 256, n // 4, dtype=np.uint8)
    span = n // row_bytes * row_bytes
    n_used = {"mid_row": span // 2 + row_bytes // 3,
              "row_end": span // 2 // row_bytes * row_bytes,
              "in_tail": span + (n - span) // 2, "all": n}[used]
    want = np.asarray(jc._structural_ascii(
        jnp.asarray(packed), jnp.uint32(n_used), row_bytes))
    got = tc._structural_ascii(torch.from_numpy(packed), n_used, row_bytes)
    assert np.array_equal(got.numpy(), want)


# -- the engines ---------------------------------------------------------

@pytest.fixture
def count_packed_steps(monkeypatch):
    """Count the port's packed extraction steps: {"masked": n,
    "structural": n}."""
    calls = {"masked": 0, "structural": 0}
    for name, key in (("_extract_step_packed", "masked"),
                      ("_extract_step_packed_structural", "structural")):
        real = getattr(tc, name)

        def step(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tc, name, step)
    return calls


def _kc(pkg, k, path, packed, monkeypatch, block_bases):
    monkeypatch.setenv("KMER_TPU_PACKED", "1" if packed else "0")
    eng = pkg.SortCountEngine(k=k, block_bases=block_bases,
                              qual_policy=("resume", k, 3))
    eng.count_paths([path])
    return (np.asarray(eng.hist(256)).tolist(), eng.total_kmers,
            eng.total_bases, eng.total_seqs)


@pytest.mark.parametrize("which,k", [
    ("reads", 31), ("genome", 15), ("clean", 21), ("dirty", 31)])
def test_kc_c4_packed_matches_jax(which, k, uniform, count_packed_steps,
                                  monkeypatch, need_native):
    """kc-c4's histogram and totals: the port packed == JAX packed == the
    port's ASCII path; the fixtures take the masked step (N bases, long
    FASTA records), the clean uniform file only the structural one, the
    other uniform file both (five 2^16-base blocks, one with an N)."""
    path, block = {"reads": (READS, 10_000_000),
                   "genome": (GENOME, 10_000_000),
                   "clean": (uniform[0], 1 << 16),
                   "dirty": (uniform[1], 1 << 16)}[which]
    want = _kc(jc, k, path, True, monkeypatch, block)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _kc(tc, k, path, True, monkeypatch, block)
    assert got == want
    steps = dict(count_packed_steps)
    assert _kc(tc, k, path, False, monkeypatch, block) == want
    assert count_packed_steps == steps  # the ASCII run packed nothing
    assert steps["structural"] > 0 if which in ("clean", "dirty") \
        else steps["structural"] == 0
    assert steps["masked"] > 0 if which != "clean" else steps["masked"] == 0


def _yak(pkg, args, capsys):
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, [ln for ln in cap.err.splitlines()
                         if ln.startswith("[M")]


@pytest.mark.parametrize("args", [["-k21", "-b19", "-K200000"],
                                  ["-k21", "-b20"]],
                         ids=["one_file", "two_files"])
def test_yak_count_packed_matches_jax(args, capsys, count_packed_steps,
                                      monkeypatch, need_native):
    """yak-count stdout and `[M` lines with KMER_TPU_PACKED=1 in the port
    == in JAX == the port's ASCII path; one file with a tap budget trip
    forced (stream-sorted tap), and two files."""
    from kmer_tpu_torch.pipeline import yak
    from kmer_tpu_torch.table import compactor

    paths = [READS] if len(args) == 3 else [READS, GENOME]
    monkeypatch.setenv("KMER_TPU_PACKED", "1")
    want = _yak("kmer_tpu", [*args, *paths], capsys)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    trips = []
    if len(paths) == 1:
        monkeypatch.setenv("KMER_TPU_TAP_BUDGET", str(1 << 20))
        monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 15)
        real = yak.YakSimTap.finish_batches

        def finish(self):
            real(self)
            trips.append(self.budget_trips)

        monkeypatch.setattr(yak.YakSimTap, "finish_batches", finish)
    got = _yak("kmer_tpu_torch", [*args, *paths], capsys)
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    assert got == want
    assert sum(count_packed_steps.values()) > 0
    if len(paths) == 1:
        assert trips and trips[0] > 0
    monkeypatch.setenv("KMER_TPU_PACKED", "0")
    assert _yak("kmer_tpu_torch", [*args, *paths], capsys) == want


# -- when it packs, and what it moves ------------------------------------

@pytest.mark.parametrize("env,paths,no_native", [
    (None, [READS], False), ("0", [READS], False), ("off", [READS], False),
    ("1", [READS], False), ("yes", [READS], False), ("1", ["-"], False),
    ("1", [READS, "-"], False), ("1", [READS], True), (None, ["-"], True)])
def test_use_packed_ingest_matches_jax(env, paths, no_native, monkeypatch):
    """Off with the env unset (the JAX package off a TPU), with `-` among
    the paths and without the native reader; on under KMER_TPU_PACKED=1
    as in JAX."""
    if env is None:
        monkeypatch.delenv("KMER_TPU_PACKED", raising=False)
    else:
        monkeypatch.setenv("KMER_TPU_PACKED", env)
    if no_native:
        monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("KMER_TPU_NO_NATIVE", raising=False)
    want = jc._use_packed_ingest(paths)
    assert tc._use_packed_ingest(paths) == want
    assert want == (env in ("1", "yes") and "-" not in paths
                    and not no_native and native.available())


def test_env_unset_does_not_pack(monkeypatch, count_packed_steps,
                                 need_native):
    monkeypatch.delenv("KMER_TPU_PACKED", raising=False)
    eng = tc.SortCountEngine(k=21, device="cpu")
    staged = _staged_bytes(eng, [READS])
    assert sum(count_packed_steps.values()) == 0
    assert staged == sum(
        b.nbytes for b, *_ in tc._iter_packed([READS], 21, eng.block_bases,
                                              eng.capacity))


def test_upload_bytes_are_the_packed_sizes(uniform, monkeypatch,
                                           need_native):
    """The staged bytes (`reader.stage` spans) count the codes and,
    where it was not elided, the mask: a quarter of the ASCII path's
    bytes on the clean file, whose masks are all elided, and more on the
    file with an N."""
    monkeypatch.setenv("KMER_TPU_PACKED", "1")
    moved = []
    for path in uniform:
        eng = tc.SortCountEngine(k=21, block_bases=1 << 16, device="cpu")
        staged = _staged_bytes(eng, [path])
        items = list(tc._iter_packed2([path], 21, eng.block_bases,
                                      eng.capacity))
        assert staged == sum(
            p.nbytes + (0 if m is None else m.nbytes) for p, m, *_ in items)
        moved.append(staged)
    ascii_bytes = sum(b.nbytes for b, *_ in tc._iter_packed(
        [uniform[0]], 21, 1 << 16, eng.capacity))
    assert moved[0] * 4 == ascii_bytes and moved[1] > moved[0]
