"""The port's KmerCompactor and SortCountEngine against the JAX package's
on the CPU: hist and n_distinct, the port's one stream-sorted path held
against the JAX package's classic and stream-sorted engines, a small
stream chunk (as tests/test_stream_sorted.py runs it), forced budget
trips, and state carried over from a JAX checkpoint.  All comparisons
are exact (integer outputs)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import u64 as U
from kmer_tpu.table import compactor as JC
from kmer_tpu_torch.kernels import keys
from kmer_tpu_torch.table import compactor as TC
from kmer_tpu_torch.utils import trace

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
CFGS = [(256, None, 1), (1024, 1023, 2), (256, 255, 3)]


def _batches(rng, n_batches, lanes_lo, lanes_hi, key_bits=40,
             sent_frac=0.15):
    out = []
    for _ in range(n_batches):
        n = int(rng.integers(lanes_lo, lanes_hi))
        hi = (rng.integers(0, 1 << (key_bits - 32), n, dtype=np.uint32)
              if key_bits > 32 else np.zeros(n, np.uint32))
        lo = rng.integers(0, 1 << min(32, key_bits), n,
                          dtype=np.uint64).astype(np.uint32)
        m = rng.random(n) < sent_frac
        hi[m] = 0xFFFFFFFF
        lo[m] = 0xFFFFFFFF
        out.append((hi, lo))
    return out


def _pair(batches, budget=2 << 30, stream=False, key_bits=40):
    """The JAX compactor (classic, or stream-sorted when `stream`) and
    the port's, fed the same batches."""
    j = JC.KmerCompactor(budget_bytes=budget, key_bits=key_bits,
                         stream_sorted=stream)
    t = TC.KmerCompactor("cpu", budget_bytes=budget)
    for hi, lo in batches:
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        t.add_raw(keys.from_hi_lo(hi, lo))
    return j, t


def _same_hists(j, t, cfgs=CFGS):
    for n_bins, max_count, min_keep in cfgs:
        h1, d1 = j.hist(n_bins, max_count, min_keep)
        h2, d2 = t.hist(n_bins, max_count, min_keep)
        assert h2.dtype == np.int64
        assert np.array_equal(h1, h2), (n_bins, max_count, min_keep)
        assert d1 == d2


@pytest.fixture
def small_chunk(monkeypatch):
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "_STREAM_CHUNK", 1 << 12)
        monkeypatch.setattr(mod, "_STREAM_MIN", 1 << 8)


def _set_port_chunk(monkeypatch, chunk):
    """The port's ladder chunk: "default" (2^24 lanes, so a small input
    stays pending until the end: the tail-only fold, pad + sort) or
    "small" (1,024 lanes, so runs merge up the ladder as they arrive)."""
    if chunk == "small":
        monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 10)
        monkeypatch.setattr(TC, "_STREAM_MIN", 1 << 8)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("key_bits", [40, 30, 64])
def test_hist_matches_jax(stream, key_bits, small_chunk):
    rng = np.random.default_rng(key_bits + stream)
    j, t = _pair(_batches(rng, 9, 300, 5000, key_bits), stream=stream,
                 key_bits=key_bits if key_bits < 64 else None)
    _same_hists(j, t)


@pytest.mark.parametrize("plain_kernels", [False, True])
def test_two_plane_ladder_merges_with_merge_path(plain_kernels, small_chunk):
    """The two-plane stream ladder merges its int64 runs with
    kernels/merge.py (merge_runs, or its plain version under
    plain_kernels), out of place: no concatenation, the runs left as they
    were; the histograms still equal the JAX bitonic ladder's."""
    from kmer_tpu_torch.kernels import merge

    rng = np.random.default_rng(17)
    batches = _batches(rng, 9, 300, 5000)
    j, _ = _pair(batches, stream=True)
    t = TC.KmerCompactor("cpu", plain_kernels=plain_kernels)
    assert t._merge is (merge.merge_runs_plain if plain_kernels
                        else merge.merge_runs)
    merges = []
    real = t._merge

    def record(a, b):
        a0, b0 = a.clone(), b.clone()
        out = real(a, b)
        assert torch.equal(a, a0) and torch.equal(b, b0)
        merges.append((a.dtype, a.shape[0], b.shape[0]))
        return out

    t._merge = record
    for hi, lo in batches:
        t.add_raw(keys.from_hi_lo(hi, lo))
    assert merges and {m[0] for m in merges} == {torch.int64}
    _same_hists(j, t)


@pytest.mark.parametrize("plain_kernels", [False, True])
def test_one_plane_ladder_merges_with_merge_path(plain_kernels, small_chunk):
    """The one-plane stream ladder (k <= 15) merges its int32 runs with
    the same functions, out of place: no concatenation, no flip, the runs
    left as they were; the histograms equal the JAX one-plane ladder's."""
    from kmer_tpu_torch.kernels import merge

    rng = np.random.default_rng(23)
    batches = _batches(rng, 9, 300, 5000, key_bits=30)
    j = JC.KmerCompactor(key_bits=30, stream_sorted=True)
    t = TC.KmerCompactor("cpu", key_bits=30, plain_kernels=plain_kernels)
    assert j.one_plane and t.one_plane
    assert t._merge is (merge.merge_runs_plain if plain_kernels
                        else merge.merge_runs)
    merges = []
    real = t._merge

    def record(a, b):
        a0, b0 = a.clone(), b.clone()
        out = real(a, b)
        assert torch.equal(a, a0) and torch.equal(b, b0)
        assert out.data_ptr() not in (a.data_ptr(), b.data_ptr())
        merges.append((a.dtype, out.dtype, out.shape[0]))
        return out

    t._merge = record
    for hi, lo in batches:
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        t.add_raw(keys.from_hi_lo(hi, lo))
    _same_hists(j, t)
    assert merges and {m[:2] for m in merges} == {(torch.int32, torch.int32)}


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_default_chunk_small_input(chunk, monkeypatch):
    """A few thousand lanes: far below the default chunk, the tail-only
    fold (pad + sort); with a small chunk, ladder merges and a tail."""
    _set_port_chunk(monkeypatch, chunk)
    rng = np.random.default_rng(9)
    j, t = _pair(_batches(rng, 2, 100, 3000))
    if chunk == "small":
        assert t.stream.ladder and t.stream.pending
    else:
        assert not t.stream.ladder
    _same_hists(j, t)


SENT_KEY = (1 << 64) - 1


def _split(k):
    k = np.asarray(k, np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _queries(rng, batches, key_bits):
    """Keys the data holds, keys below 2^key_bits it mostly does not,
    and duplicates of both, as (hi, lo) planes."""
    data = np.concatenate([(hi.astype(np.uint64) << np.uint64(32)) | lo
                           for hi, lo in batches])
    data = data[data != SENT_KEY]
    q = np.concatenate([rng.choice(data, 300),
                        rng.integers(0, 1 << key_bits, 100, dtype=np.uint64)])
    return _split(np.concatenate([q, q[:40], q[-20:]]))


def _count_trips(t):
    """Wrap t.compact: the list it returns grows by one a call."""
    calls, real = [], t.compact
    t.compact = lambda: calls.append(1) or real()
    return calls


def _same_compacted(j, t, u):
    """After compact(): the port's run equals the JAX package's (its
    sentinel padding dropped) and the no-trip port engine's u, and
    last_n_unique agrees."""
    for c in (j, t, u):
        c.compact()
    assert t.last_n_unique == j.last_n_unique == u.last_n_unique
    (jh, jl, jc), = j.runs
    (tk, tc), = t.runs
    jh, jl, jc = np.asarray(jh), np.asarray(jl), np.asarray(jc)
    keep = ~((jh == 0xFFFFFFFF) & (jl == 0xFFFFFFFF))
    assert torch.equal(tk, keys.from_hi_lo(jh[keep], jl[keep]))
    assert np.array_equal(tc.numpy().view(np.uint32), jc[keep])
    assert torch.equal(tk, u.runs[0][0]) and torch.equal(tc, u.runs[0][1])


@pytest.mark.parametrize("stream, key_bits", [
    pytest.param(False, 40, id="False"), pytest.param(True, 40, id="True"),
    pytest.param(False, 30, id="False-one_plane"),
    pytest.param(True, 30, id="True-one_plane")])
def test_budget_trips_match_jax(stream, key_bits, small_chunk):
    """A small budget forces many folds mid-stream (the ladder compacted
    run by run), one-plane and two-plane: each fold merges new counted
    runs into the standing plane.  The weighted segment histogram,
    counts_for (duplicates and absent keys), last_n_unique and the run
    after compact() all equal the JAX package's in the mode `stream`
    names, which counts without trips, and the port's without trips."""
    rng = np.random.default_rng(5 + stream + 100 * (key_bits != 40))
    batches = _batches(rng, 12, 2000, 4000, key_bits)
    j = JC.KmerCompactor(key_bits=key_bits, stream_sorted=stream)
    t, u = (TC.KmerCompactor("cpu", budget_bytes=budget, key_bits=key_bits)
            for budget in (20_000, 2 << 30))
    trips = _count_trips(t)
    for hi, lo in batches:
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        for c in (t, u):
            c.add_raw(keys.from_hi_lo(hi, lo))
    assert t.one_plane == (key_bits == 30)
    assert t.runs and t.runs[0][1] is not None  # compacted
    assert len(trips) >= 5 and not u.runs
    qhi, qlo = _queries(rng, batches, key_bits)
    want = j.counts_for(qhi, qlo)
    assert np.array_equal(t.counts_for(qhi, qlo), want)
    assert np.array_equal(u.counts_for(qhi, qlo), want)
    _same_hists(j, t)
    _same_compacted(j, t, u)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("key_bits", [40, 30])
def test_unsorted_counted_runs_through_folds(stream, key_bits, small_chunk):
    """Counted runs from add_counted (unsorted keys, duplicates, counts
    near 2^32 so that per-key totals wrap) before the first trip and
    after one: each sorts once and folds with the ladder's runs into the
    standing plane; every output equals the JAX package's (in the mode
    `stream` names) and the no-trip port's."""
    rng = np.random.default_rng(31 + stream + key_bits)
    batches = _batches(rng, 10, 2000, 4000, key_bits)
    pool = np.unique(np.concatenate([
        (hi.astype(np.uint64) << np.uint64(32)) | lo
        for hi, lo in batches[:3]]))
    pool = pool[pool != SENT_KEY]
    j = JC.KmerCompactor(key_bits=key_bits, stream_sorted=stream)
    # the one-plane ladder counts 4 B a raw lane, so half the budget
    # trips as often as 8 B lanes under the whole
    t, u = (TC.KmerCompactor("cpu", budget_bytes=budget, key_bits=key_bits)
            for budget in (40_000 if key_bits > 30 else 20_000, 2 << 30))
    trips = _count_trips(t)
    for i, (hi, lo) in enumerate(batches):
        if i in (1, 6):
            k = rng.choice(pool, 900)  # unsorted, with duplicates
            c = rng.integers(0xF0000000, 1 << 32, k.shape[0],
                             dtype=np.uint64).astype(np.uint32)
            khi, klo = _split(k)
            j.add_counted(U.U64(jnp.asarray(khi), jnp.asarray(klo)),
                          jnp.asarray(c))
            for comp in (t, u):
                comp.add_counted(keys.from_hi_lo(khi, klo),
                                 torch.from_numpy(c.view(np.int32)))
            assert i == 1 or t.runs[0][1] is not None  # after a trip
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        for comp in (t, u):
            comp.add_raw(keys.from_hi_lo(hi, lo))
    assert len(trips) >= 3
    qhi, qlo = _queries(rng, batches, key_bits)
    want = j.counts_for(qhi, qlo)
    assert np.array_equal(t.counts_for(qhi, qlo), want)
    assert np.array_equal(u.counts_for(qhi, qlo), want)
    _same_hists(j, t)
    _same_compacted(j, t, u)


@pytest.mark.parametrize("chunk, key_bits", [("default", 40), ("small", 40),
                                             ("small", 30)])
def test_trips_rearm_on_new_lanes(chunk, key_bits, monkeypatch):
    """The budget counts the raw bytes added since the last fold, not
    the standing plane's: N raw lanes under budget B trip at most
    ceil(8 N / B) times, whatever the plane holds.  Twelve batches of
    1,000 lanes under 20,000 bytes: at 8 B a lane every third batch
    trips (4 times); the one-plane ladder counts 4 B a lane, so every
    sixth (2 times).  With the default chunk a trip folds pending lanes
    only; with a small one, ladder runs too."""
    _set_port_chunk(monkeypatch, chunk)
    rng = np.random.default_rng(2)
    batches = _batches(rng, 12, 1000, 1001, key_bits, sent_frac=0)
    t = TC.KmerCompactor("cpu", budget_bytes=20_000, key_bits=key_bits)
    trips = _count_trips(t)
    for hi, lo in batches:
        t.add_raw(keys.from_hi_lo(hi, lo))
    assert len(trips) <= -(-8 * 12_000 // 20_000)
    assert len(trips) == (2 if t.one_plane else 4)
    assert t.last_n_unique * 12 > 20_000  # the plane alone would trip
    j, _ = _pair(batches, key_bits=key_bits)
    _same_hists(j, t)


def test_compact_then_more_adds(small_chunk):
    """compact() mid-stream, then more raw adds: a mixed state."""
    rng = np.random.default_rng(11)
    batches = _batches(rng, 8, 800, 4000)
    j, t = _pair(batches[:4], stream=True)
    j.compact()
    t.compact()
    assert t.last_n_unique == j.last_n_unique
    for hi, lo in batches[4:]:
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        t.add_raw(keys.from_hi_lo(hi, lo))
    _same_hists(j, t)


def test_compacted_run_matches_jax(small_chunk):
    rng = np.random.default_rng(3)
    j, t = _pair(_batches(rng, 5, 1000, 3000), stream=True)
    j.compact()
    t.compact()
    (jh, jl, jc), = j.runs
    (tk, tc), = t.runs
    jh, jl, jc = np.asarray(jh), np.asarray(jl), np.asarray(jc)
    keep = ~((jh == 0xFFFFFFFF) & (jl == 0xFFFFFFFF))
    want_keys = keys.from_hi_lo(jh[keep], jl[keep])
    assert torch.equal(tk, want_keys)
    assert np.array_equal(tc.numpy().view(np.uint32), jc[keep])


def test_engine_matches_jax_on_fixture(monkeypatch):
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    for stream in ("0", "1"):  # the JAX engine's mode
        monkeypatch.setenv("KMER_TPU_STREAM_SORT", stream)
        je = JEngine(k=21, block_bases=1 << 16)
        je.count_paths([READS])
        te = SortCountEngine(k=21, block_bases=1 << 16, device="cpu")
        trace.clear()
        trace.enable(True)
        try:
            te.count_paths([READS])
        finally:
            trace.enable(False)
        assert np.array_equal(je.hist(256, 1023), te.hist(256, 1023))
        assert (te.total_kmers, te.total_bases, te.total_seqs) == (
            je.total_kmers, je.total_bases, je.total_seqs)
        # the loop's span: a lane appended for every k-mer (pads
        # beside), and its waits and dispatches are the stats' times
        rec = trace.spans()
        loop, = [s for s in rec if s.name == "count.loop"]
        assert loop.attrs["lanes_added"] >= te.total_kmers > 0
        for name, field in (("ingest.wait", "wait_s"),
                            ("ingest.dispatch", "dispatch_s")):
            got = sum(s.t1 - s.t0 for s in rec
                      if s.name == name and s.parent == loop.id)
            assert got == pytest.approx(getattr(te.stats, field),
                                        rel=1e-9, abs=1e-12)
        trace.clear()


def test_state_from_jax_checkpoint(tmp_path, monkeypatch):
    """A JAX checkpoint loads into the port (add_counted), and counting
    continues to the same histogram as the JAX engine's."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    genome = os.path.join(FIXTURES, "genome_small.fa.gz")
    je = JEngine(k=31, block_bases=1 << 16)
    je.count_paths([READS])
    ckpt = str(tmp_path / "state.npz")
    je.save_checkpoint(ckpt)
    want_saved = je.hist(256, None)
    je.count_paths([genome])
    want = [(je.hist(*cfg), je._n_distinct) for cfg in CFGS[:2]]
    for chunk in ("default", "small"):
        _set_port_chunk(monkeypatch, chunk)
        te = SortCountEngine.from_jax_checkpoint(ckpt, block_bases=1 << 16,
                                                 device="cpu")
        assert te.k == 31
        assert np.array_equal(te.hist(256, None), want_saved)
        te.count_paths([genome])
        for cfg, (h, nd) in zip(CFGS[:2], want):
            assert np.array_equal(te.hist(*cfg), h)
            assert te._n_distinct == nd
        assert te.total_kmers == je.total_kmers
        assert te.total_bases == je.total_bases


def test_device_rule(monkeypatch):
    import kmer_tpu_torch

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    assert kmer_tpu_torch.default_device() == torch.device("cpu")
    monkeypatch.setenv("KMER_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        kmer_tpu_torch.default_device()
    monkeypatch.delenv("KMER_TPU_PLATFORM")
    if torch.cuda.is_available():
        assert kmer_tpu_torch.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kmer_tpu_torch.default_device()


@pytest.mark.parametrize("budget", [2 << 30, 20_000])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("k", [11, 15])
def test_one_plane_matches_jax(k, stream, budget, small_chunk):
    """KmerCompactor(key_bits=2k) at k <= 15 runs one-plane: the ladder
    holds int32 lanes and merges them with merge_runs on int32 runs;
    with or without budget trips its histograms equal the JAX one-plane
    compactor's in the mode `stream` names (which counts without
    trips)."""
    rng = np.random.default_rng(k + 10 * stream + (budget < 1 << 20))
    batches = _batches(rng, 10, 300, 5000, key_bits=2 * k)
    j = JC.KmerCompactor(key_bits=2 * k, stream_sorted=stream)
    t = TC.KmerCompactor("cpu", budget_bytes=budget, key_bits=2 * k)
    assert j.one_plane and t.one_plane
    merges = []
    real = t._merge
    t._merge = lambda a, b: merges.append(a.dtype) or real(a, b)
    held = set()  # dtypes the ladder held between adds (trips empty it)
    for hi, lo in batches:
        j.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        t.add_raw(keys.from_hi_lo(hi, lo))
        held |= {p[0].dtype for p in
                 list(t.stream.ladder.values()) + t.stream.pending}
    assert held == {torch.int32}
    assert merges and set(merges) == {torch.int32}
    if budget < 1 << 20:
        assert t.runs and t.runs[0][1] is not None  # compacted
    _same_hists(j, t)


def test_one_plane_engine_matches_jax(monkeypatch):
    """The port's engine at k=15 (one-plane, small chunk) against the
    JAX stream-sorted engine on the fixture."""
    from kmer_tpu.pipeline.counter import SortCountEngine as JEngine
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 14)
    monkeypatch.setenv("KMER_TPU_STREAM_SORT", "1")
    je = JEngine(k=15, block_bases=1 << 16)
    je.count_paths([READS])
    te = SortCountEngine(k=15, block_bases=1 << 16, device="cpu",
                         budget_bytes=1 << 18)
    assert te.compactor.one_plane
    te.count_paths([READS])
    for cfg in CFGS:
        assert np.array_equal(je.hist(*cfg), te.hist(*cfg))
        assert te._n_distinct == je._n_distinct
    assert not SortCountEngine(k=16, device="cpu").compactor.one_plane
