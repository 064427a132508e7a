"""The port's `counts_for` (KmerCompactor and SortCountEngine), its
checkpoints and the engine factory's arguments against the JAX package's,
on the CPU.  Every comparison is exact (integer outputs, tolerance 0).

Compactor states, as the JAX package names them: classic raw runs,
counted runs only, mixed (stream runs + counted runs; the port folds both
into one counted plane), stream only (the folded ladder plane, sentinel
lanes included), and stream after a forced budget trip (counted runs from
the trip, then more stream runs), each at one-plane and two-plane key
widths.  The port always accumulates through its stream ladder; the
state's mode is the JAX compactor's.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import u64 as U
from kmer_tpu.table import compactor as JC
from kmer_tpu_torch.kernels import keys
from kmer_tpu_torch.pipeline import counter as TCounter
from kmer_tpu_torch.table import compactor as TC

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
ALL_ONES = (1 << 64) - 1


@pytest.fixture
def small_chunk(monkeypatch):
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "_STREAM_CHUNK", 1 << 12)
        monkeypatch.setattr(mod, "_STREAM_MIN", 1 << 8)


def _split(k):
    k = np.asarray(k, np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _pool(rng, key_bits, n):
    """n distinct keys below 2^key_bits (never the all-ones sentinel)."""
    top = (1 << key_bits) - (1 if key_bits == 64 else 0)
    k = rng.integers(0, top, n, dtype=np.uint64, endpoint=key_bits < 64)
    return np.unique(k)


def _raw_batches(rng, pool, n_batches, lanes, sent_frac=0.15):
    out = []
    for _ in range(n_batches):
        k = rng.choice(pool, int(rng.integers(lanes // 2, lanes)))
        k[rng.random(k.shape[0]) < sent_frac] = ALL_ONES
        out.append(k)
    return out


def _counted_runs(rng, pool, n_runs):
    """(keys, uint32 counts) runs; counts near 2^32 make per-key totals
    pass 2^32 and the global cumsum wrap many times."""
    out = []
    for _ in range(n_runs):
        k = rng.choice(pool, 700)
        c = rng.integers(0, 1 << 32, k.shape[0], dtype=np.uint64)
        out.append((k, c.astype(np.uint32)))
    return out


class Pair:
    """A JAX compactor (classic, or stream-sorted when `stream`) and the
    port's, fed the same runs."""

    def __init__(self, key_bits, stream=False, budget=2 << 30):
        self.j = JC.KmerCompactor(key_bits=key_bits, stream_sorted=stream)
        self.t = TC.KmerCompactor("cpu", budget_bytes=budget,
                                  key_bits=key_bits)

    def add_raw(self, k):
        hi, lo = _split(k)
        self.j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        self.t.add_raw(keys.from_hi_lo(hi, lo))

    def add_counted(self, k, c):
        hi, lo = _split(k)
        self.j.add_counted(U.U64(jnp.asarray(hi), jnp.asarray(lo)),
                           jnp.asarray(c))
        self.t.add_counted(keys.from_hi_lo(hi, lo),
                           torch.from_numpy(c.view(np.int32)))

    def counts_for(self, q):
        hi, lo = _split(q)
        want = self.j.counts_for(hi, lo)
        got = self.t.counts_for(hi, lo)
        assert got.dtype == np.int64 and got.shape == (len(q),)
        assert np.array_equal(got, want)
        return got


def _queries(rng, pool, data, key_bits):
    """Present and absent keys, duplicates, the data's smallest and
    largest keys and their neighbours outside the data, key 0, and (with
    two planes) the all-ones key."""
    real = data[data != ALL_ONES]
    lo, hi = int(real.min()), int(real.max())
    edge = [lo, hi, 0]
    if lo > 0:
        edge.append(lo - 1)
    if hi + 1 < (1 << key_bits) and hi + 1 != ALL_ONES:
        edge.append(hi + 1)
    if key_bits > 30:
        edge.append(ALL_ONES)
    q = np.concatenate([rng.choice(pool, 300),
                        _pool(rng, key_bits, 100),
                        np.asarray(edge, np.uint64)])
    return np.concatenate([q, q[:40], q[-len(edge):]])


STATES = ["raw", "counted", "mixed", "stream", "stream_trip"]


@pytest.mark.parametrize("key_bits", [30, 42, 62, 64])
@pytest.mark.parametrize("state", STATES)
def test_compactor_counts_for_matches_jax(state, key_bits, small_chunk):
    rng = np.random.default_rng(STATES.index(state) * 100 + key_bits)
    pool = _pool(rng, key_bits, 3000)
    stream = state in ("mixed", "stream", "stream_trip")
    # the trip state: a 40 kB budget compacts the port's runs mid-stream
    # (the JAX side counts without trips), and a last small batch leaves
    # stream runs beside the counted ones
    p = Pair(key_bits, stream,
             budget=40_000 if state == "stream_trip" else 2 << 30)
    data = []
    if state != "counted":
        for k in _raw_batches(rng, pool, 8, 4000) + [rng.choice(pool, 100)]:
            p.add_raw(k)
            data.append(k)
    if state in ("counted", "mixed"):
        for k, c in _counted_runs(rng, pool, 3):
            p.add_counted(k, c)
            data.append(k)
    assert p.t.one_plane == (key_bits == 30)
    if state == "stream_trip":
        assert p.t.runs[0][1] is not None and p.t.stream  # mixed after trip
    if state == "stream":
        assert p.t.stream and not p.t.runs
    got = p.counts_for(_queries(rng, pool, np.concatenate(data), key_bits))
    assert got.any()
    # a second call reads the state the first one left
    p.counts_for(pool[:50])


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_counts_for_exact_values(chunk, monkeypatch):
    """Duplicated, absent and edge queries against known counts; the
    largest key with no sentinel lane after it (2^16 data lanes fill the
    stream's padded run exactly, the JAX package's off-by-one guard at
    compactor.py:725-730); absent keys below the smallest and above the
    largest; the all-ones key counts 0 in both packages.  The port's
    ladder either holds the lanes pending (the default chunk) or merges
    16 chunks of 2^12 into the one run."""
    if chunk == "small":
        monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 12)
    n = TC._STREAM_MIN
    assert n == JC._STREAM_MIN
    p = Pair(64, True)
    data = np.arange(5, n + 5, dtype=np.uint64)  # max key n + 4
    p.add_raw(data)
    q = np.asarray([n + 4, n + 4, n + 5, 4, 0, 5, 6, ALL_ONES, n + 4],
                   np.uint64)
    assert p.counts_for(q).tolist() == [1, 1, 0, 0, 0, 1, 1, 0, 1]
    assert p.t.stream.planes()[0].shape[0] == n  # no sentinel tail
    p.add_raw(np.asarray([ALL_ONES] * 3 + [n + 4] * 2, np.uint64))
    assert p.counts_for(q[:2]).tolist() == [3, 3]
    assert p.counts_for(q[7:8]).tolist() == [0]


@pytest.mark.parametrize("key_bits", [30, 64])
def test_counts_for_weighted_wrap(key_bits):
    """Counted runs whose per-key totals pass 2^32: each total keeps its
    low 32 bits (the JAX package's modular uint32 cumsum), however often
    the global cumsum wraps; duplicated queries and an absent one."""
    keys_ = np.arange(1, 51, dtype=np.uint64) * 977
    p = Pair(key_bits)
    big = np.full(50, 0xF0000000, np.uint32)
    for _ in range(3):
        p.add_counted(keys_, big)
    p.add_counted(keys_[:10], np.arange(10, dtype=np.uint32))
    got = p.counts_for(np.concatenate([keys_, keys_[:5], [978]]))
    want = [(3 * 0xF0000000 + (i if i < 10 else 0)) & 0xFFFFFFFF
            for i in range(50)]
    assert got.tolist() == want + want[:5] + [0]


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_counts_for_empty(chunk, monkeypatch):
    """An empty engine answers zeros, one per query (also for no
    queries); an engine with data answers an empty query list.  With a
    2-lane chunk the three lanes make a ladder run, a padded tail and a
    merge."""
    if chunk == "small":
        monkeypatch.setattr(TC, "_STREAM_CHUNK", 2)
        monkeypatch.setattr(TC, "_STREAM_MIN", 2)
    p = Pair(42)
    assert p.counts_for(np.asarray([1, 2, 2], np.uint64)).tolist() == [0] * 3
    assert p.counts_for(np.zeros(0, np.uint64)).shape == (0,)
    p.add_raw(np.asarray([7, 7, 9], np.uint64))
    assert p.counts_for(np.zeros(0, np.uint64)).shape == (0,)
    assert p.counts_for(np.asarray([7, 9, 8], np.uint64)).tolist() == [2, 1, 0]


def test_one_plane_query_bound():
    """One-plane mode keeps the JAX package's assertion that the query
    keys fit the declared key_bits."""
    t = TC.KmerCompactor("cpu", key_bits=30)
    t.add_raw(keys.from_hi_lo(np.zeros(3, np.uint32),
                              np.asarray([1, 2, 3], np.uint32)))
    with pytest.raises(AssertionError, match="key_bits"):
        t.counts_for(np.asarray([1], np.uint32), np.asarray([0], np.uint32))


# -- the engine ----------------------------------------------------------


def _fixture_queries(path, k, n_keys=1500):
    """hash64 of canonical k-mers from the start of a fixture (keys the
    engine holds), plus absent keys."""
    from kmer_tpu_torch.io.fastx import FastxReader
    from kmer_tpu_torch.utils.seq import canonical_kmer, encode_kmer, hash64_np

    can = []
    for _name, seq in FastxReader(path):
        if len(can) >= n_keys:
            break
        for off in range(0, len(seq) - k + 1, 17):
            enc = encode_kmer(seq[off:off + k], k)
            if enc >= 0:
                can.append(canonical_kmer(enc, k))
    mask = (1 << (2 * k)) - 1
    rng = np.random.default_rng(k)
    q = np.concatenate([hash64_np(np.asarray(can, np.uint64), mask),
                        rng.integers(0, mask, 64, dtype=np.uint64)])
    return _split(q)


@pytest.mark.parametrize("stream", ["0", "1"])
@pytest.mark.parametrize("path", [READS, GENOME], ids=["reads", "genome"])
def test_engine_counts_for_matches_jax(path, stream, monkeypatch):
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine

    monkeypatch.setenv("KMER_TPU_STREAM_SORT", stream)
    monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 15)
    k = 21
    qhi, qlo = _fixture_queries(path, k)
    je = JEngine(k=k, block_bases=1 << 16)
    je.count_paths([path])
    te = TCounter.SortCountEngine(k=k, block_bases=1 << 16, device="cpu")
    te.count_paths([path])
    want = je.counts_for(qhi, qlo)
    got = te.counts_for(qhi, qlo)
    assert np.array_equal(got, want) and got.dtype == np.int64
    assert (got[:-64] > 0).all()


@pytest.mark.parametrize("prefetch", [True, False])
def test_factory_budget_prefetch_progress(prefetch, monkeypatch):
    """make_count_engine passes budget_bytes and prefetch on;
    count_paths calls progress(engine) once a block, as the JAX engine
    does; prefetch=False reads in the calling thread.  A small budget
    trips compactions, and the histogram still equals the JAX one."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("KMER_TPU_STREAM_SORT", "1")
    me = threading.current_thread()
    readers = []
    real = TCounter._iter_packed

    def iter_packed(*a, **kw):
        for item in real(*a, **kw):
            readers.append(threading.current_thread())
            yield item

    monkeypatch.setattr(TCounter, "_iter_packed", iter_packed)
    je = JEngine(k=21, block_bases=1 << 16, prefetch=prefetch)
    te = TCounter.make_count_engine(k=21, block_bases=1 << 16,
                                    budget_bytes=300_000, prefetch=prefetch)
    assert te.compactor.budget_bytes == 300_000 and te.prefetch == prefetch
    calls = {"jax": [], "port": []}
    je.count_paths([READS], progress=lambda e: calls["jax"].append(e))
    te.count_paths([READS], progress=lambda e: calls["port"].append(
        (e, threading.current_thread(), e.total_bases)))
    assert len(calls["port"]) == len(calls["jax"]) > 1
    assert all(e is te and th is me for e, th, _ in calls["port"])
    bases = [b for _, _, b in calls["port"]]
    assert bases == sorted(bases) and bases[-1] == te.total_bases
    assert readers and all((r is me) != prefetch for r in readers)
    assert te.compactor.runs and te.compactor.runs[0][1] is not None
    assert np.array_equal(te.hist(256, 1023), je.hist(256, 1023))
    assert te._n_distinct == je._n_distinct


@pytest.mark.parametrize("value,want", [
    (None, 4), ("1", 1), ("7", 7), ("0", 1), ("-3", 1), ("x", 4), ("", 4)])
def test_throttle_window_env(value, want, monkeypatch):
    """KMER_TPU_THROTTLE_WINDOW as the JAX compactor reads it (at least
    1; 4 when unset or not an integer), read once per compactor."""
    if value is None:
        monkeypatch.delenv("KMER_TPU_THROTTLE_WINDOW", raising=False)
    else:
        monkeypatch.setenv("KMER_TPU_THROTTLE_WINDOW", value)
    j = JC.KmerCompactor(stream_sorted=True)
    j._throttle_push((jnp.zeros(8, jnp.uint32),))
    t = TC.KmerCompactor("cpu")
    assert t._throttle_window == j._sync_window == want
    monkeypatch.setenv("KMER_TPU_THROTTLE_WINDOW", "99")
    assert t._throttle_window == want


# -- checkpoints, both ways ----------------------------------------------


@pytest.fixture(scope="module")
def uninterrupted():
    """The JAX engine over both fixtures in one run: (histogram,
    n_distinct, totals, the genome queries, their counts)."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine

    full = JEngine(k=21, block_bases=1 << 16)
    full.count_paths([READS, GENOME])
    qhi, qlo = _fixture_queries(GENOME, 21)
    return (full.hist(256, max_count=1023), full._n_distinct,
            (full.total_bases, full.total_seqs, full.total_kmers),
            (qhi, qlo), full.counts_for(qhi, qlo))


def _same_as_uninterrupted(eng, want):
    hist, nd, totals, (qhi, qlo), counts = want
    assert np.array_equal(eng.counts_for(qhi, qlo), counts)
    assert np.array_equal(eng.hist(256, max_count=1023), hist)
    assert eng._n_distinct == nd
    assert (eng.total_bases, eng.total_seqs, eng.total_kmers) == totals


@pytest.mark.parametrize("stream", ["0", "1"])
def test_checkpoint_port_to_jax(stream, tmp_path, monkeypatch,
                                uninterrupted):
    """The port saves after the first file (the "kill": only the file
    survives); the JAX engine resumes it and counts the second; the
    result equals an uninterrupted run.  The file holds the JAX layout:
    the distinct keys as hi/lo uint32, uint32 counts, int64 meta."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine

    monkeypatch.setenv("KMER_TPU_STREAM_SORT", stream)
    ck = str(tmp_path / "count.ckpt.npz")
    e1 = TCounter.SortCountEngine(k=21, block_bases=1 << 16, device="cpu")
    e1.count_paths([READS])
    e1.save_checkpoint(ck)
    assert not os.path.exists(ck + ".tmp.npz")
    z = np.load(ck)
    assert {n: z[n].dtype for n in z.files} == {
        "hi": np.uint32, "lo": np.uint32, "cnt": np.uint32,
        "meta": np.int64}
    assert z["meta"].tolist() == [21, e1.total_bases, e1.total_seqs,
                                  e1.total_kmers]
    assert z["hi"].size == e1.compactor.last_n_unique > 0
    del e1

    e2 = JEngine.resume_checkpoint(ck, block_bases=1 << 16)
    e2.count_paths([GENOME])
    _same_as_uninterrupted(e2, uninterrupted)


@pytest.mark.parametrize("stream", ["0", "1"])
def test_checkpoint_jax_to_port(stream, tmp_path, monkeypatch,
                                uninterrupted):
    """The JAX engine saves after the first file; the port resumes it
    (resume_checkpoint, and from_jax_checkpoint, its alias) and counts
    the second; histogram, counts_for and totals equal an uninterrupted
    run's.  The port's own file, saved after resuming, equals the JAX
    file's keys and counts without the JAX package's sentinel padding."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine

    monkeypatch.setenv("KMER_TPU_STREAM_SORT", stream)
    ck = str(tmp_path / "count.ckpt.npz")
    e1 = JEngine(k=21, block_bases=1 << 16)
    e1.count_paths([READS])
    e1.save_checkpoint(ck)
    del e1
    assert (TCounter.SortCountEngine.from_jax_checkpoint.__func__
            is TCounter.SortCountEngine.resume_checkpoint.__func__)

    ck2 = str(tmp_path / "port.ckpt.npz")
    e0 = TCounter.SortCountEngine.resume_checkpoint(ck, device="cpu")
    e0.save_checkpoint(ck2)
    zj, zt = np.load(ck), np.load(ck2)
    real = ~((zj["hi"] == 0xFFFFFFFF) & (zj["lo"] == 0xFFFFFFFF))
    for name in ("hi", "lo", "cnt"):
        assert np.array_equal(zt[name], zj[name][real]), name
    assert np.array_equal(zt["meta"], zj["meta"])

    e2 = TCounter.SortCountEngine.resume_checkpoint(
        ck, block_bases=1 << 16, device="cpu")
    e2.count_paths([GENOME])
    _same_as_uninterrupted(e2, uninterrupted)
