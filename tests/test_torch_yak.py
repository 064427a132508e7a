"""The port's yak modules (kmer_tpu_torch.kernels.bloom,
kmer_tpu_torch.pipeline.yak_admit, kmer_tpu_torch.pipeline.yak) against
the JAX package's on the CPU, and the deferred admission against the
lane-by-lane sequential oracle of tests/test_yak_admit.py.

Inputs are made with numpy from a seed; the same inputs go to both
packages.  Every output is an integer: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import bloom as jbloom
from kmer_tpu.kernels import u64
from kmer_tpu.pipeline import yak_admit as JA
from kmer_tpu_torch.kernels import bloom, keys
from kmer_tpu_torch.pipeline import yak_admit as TA
from tests.test_yak_admit import _oracle, _rand_planes

U32_SENT = 0xFFFFFFFF


# -- bloom probes -------------------------------------------------------

@pytest.mark.parametrize("n_hashes", [1, 3, 4])
@pytest.mark.parametrize("pre,n_shift", [(4, 14), (4, 22), (4, 31),
                                         (10, 22), (10, 31)])
def test_probe_indices_match_jax(pre, n_shift, n_hashes):
    """Per lane, the port's probes equal kmer_tpu's _probe_indices,
    including keys with the top bit set (k = 32) and all-ones keys."""
    rng = np.random.default_rng(pre * 100 + n_shift * 10 + n_hashes)
    n = 20_000
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    k[: n // 4] >>= np.uint64(34)  # short keys, as at small k
    k[n // 4: n // 2] |= np.uint64(1 << 63)  # top bit set
    k[:4] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(U32_SENT)).astype(np.uint32)
    jspec = jbloom.BloomSpec(pre, n_shift, n_hashes)
    want = jbloom._probe_indices(u64.U64(jnp.asarray(hi), jnp.asarray(lo)),
                                 jspec)
    got = bloom.probe_indices(torch.from_numpy(keys.from_u64(k)),
                              bloom.BloomSpec(pre, n_shift, n_hashes))
    assert len(got) == len(want) == n_hashes
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        assert int(g.min()) >= 0 and int(g.max()) < 1 << n_shift


# -- deferred admission -------------------------------------------------

def _port_keys(hi, lo):
    return keys.from_hi_lo(hi, lo)


def _blocks(n, bounds, block):
    """(start, end, batch_end) of each block, as tests/test_yak_admit.py
    `_drive` cuts them."""
    bset = set(bounds)
    start = 0
    for end in sorted(bset | set(range(block, n, block))) + [n]:
        if end > start:
            yield start, end, end in bset
            start = end


def _set_chunk(monkeypatch, chunk, lanes=1 << 10):
    """The tap ladder's chunk: "default" (2^24 lanes, so these inputs
    stay pending until a compaction) or "small" (`lanes`, so chunks are
    sorted and runs merge as they arrive)."""
    from kmer_tpu_torch.table import compactor

    if chunk == "small":
        monkeypatch.setattr(compactor, "_STREAM_CHUNK", lanes)
        monkeypatch.setattr(compactor, "_STREAM_MIN", 1 << 8)


def _first2_of(hi, lo, idx=None):
    """Each key's first two (key, idx) lanes of the whole input: a numpy
    (key, idx) sort, then the tap's keep pass."""
    k = _port_keys(hi, lo)
    i = torch.arange(len(hi)) if idx is None else idx
    order = torch.from_numpy(np.lexsort((i.numpy(), k.numpy())))
    return TA._first2_keep(k[order], i[order])


def _drive_port(hi, lo, bounds, spec, use_bloom, block=997, budget=1 << 30):
    adm = TA.DeferredYakAdmission(spec, use_bloom, budget_bytes=budget)
    for a, b, end in _blocks(len(hi), bounds, block):
        adm.add_block(_port_keys(hi[a:b], lo[a:b]), batch_end=end)
    return adm


def _drive_jax(hi, lo, bounds, spec, use_bloom, block=997):
    adm = JA.DeferredYakAdmission(spec, use_bloom, stream_sorted=False)
    for a, b, end in _blocks(len(hi), bounds, block):
        adm.add_block(jnp.asarray(hi[a:b]), jnp.asarray(lo[a:b]),
                      batch_end=end)
    return adm.finish()


def _specs(n_shift, use_bloom):
    if not use_bloom:
        return None, None
    return (jbloom.BloomSpec(4, n_shift, 4), bloom.BloomSpec(4, n_shift, 4))


@pytest.mark.parametrize("chunk", ["default", "small"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,n_keys,n_shift,use_bloom", [
    (6000, 900, 14, True),   # dense bloom: many false positives
    (6000, 900, 22, True),   # sparse bloom
    (4000, 700, 14, False),  # no bloom: first occurrences
])
def test_deferred_matches_jax_and_oracle(n, n_keys, n_shift, use_bloom, seed,
                                         chunk, monkeypatch):
    # a small stream chunk, so the (key, index) ladder sorts chunks and
    # merges runs (as tests/test_stream_sorted.py shrinks the JAX one);
    # the default one leaves every lane pending until the end
    _set_chunk(monkeypatch, chunk, 1 << 11)
    rng = np.random.default_rng(seed)
    hi, lo = _rand_planes(rng, n, n_keys)
    n_batches = int(rng.integers(2, 6))
    bounds = sorted(
        rng.choice(np.arange(1, n), n_batches - 1, replace=False).tolist()
    ) + [n]
    jspec, tspec = _specs(n_shift, use_bloom)
    want = _oracle(hi, lo, bounds, jspec, use_bloom)
    jpb, jtot = _drive_jax(hi, lo, bounds, jspec, use_bloom)
    adm = _drive_port(hi, lo, bounds, tspec, use_bloom)
    assert bool(adm.fs.stream.ladder) == (chunk == "small")
    pb, tot = adm.finish()
    assert list(pb) == list(jpb) == want[0]
    assert tot == jtot == want[1]
    assert adm.fs.stream.ladder == {} and adm.fs._compacted is not None


@pytest.mark.parametrize("plain_kernels", [False, True])
def test_tap_ladder_merges_with_merge_runs3(plain_kernels, monkeypatch):
    """The tap's stream ladder merges (key, index) runs with
    kernels/merge.py (merge_runs3, or its plain version under
    plain_kernels), out of place; after a budget trip the standing
    first-2 run merges with the new lanes unpadded, at unequal lengths.
    The totals equal the JAX package's and the oracle's, and the first-2
    planes equal those of a (key, idx) sort of the whole input."""
    from kmer_tpu_torch.kernels import merge
    from kmer_tpu_torch.table import compactor

    monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 10)
    monkeypatch.setattr(compactor, "_STREAM_MIN", 1 << 8)
    rng = np.random.default_rng(31)
    n = 9000
    hi, lo = _rand_planes(rng, n, 1200)
    bounds = [2500, 6100, n]
    jspec, tspec = _specs(14, True)
    want = _oracle(hi, lo, bounds, jspec, True)
    adm = TA.DeferredYakAdmission(tspec, True, budget_bytes=40_000,
                                  plain_kernels=plain_kernels)
    fs = adm.fs
    assert fs._merge is (merge.merge_runs3_plain if plain_kernels
                         else merge.merge_runs3)
    sizes = []
    real = fs._merge

    def record(*planes):
        before = [p.clone() for p in planes]
        out = real(*planes)
        assert all(torch.equal(p, q) for p, q in zip(planes, before))
        assert not {o.data_ptr() for o in out} & {p.data_ptr()
                                                  for p in planes}
        sizes.append((planes[0].shape[0], planes[2].shape[0]))
        return out

    fs._merge = record
    for a, b, end in _blocks(n, bounds, 997):
        adm.add_block(_port_keys(hi[a:b], lo[a:b]), batch_end=end)
    planes = fs.first2_planes()
    assert fs.trips > 1
    assert any(na != nb for na, nb in sizes)  # the standing run, unpadded
    assert any(na == nb for na, nb in sizes)  # the ladder's carries
    wk, wi = _first2_of(hi, lo)
    assert torch.equal(planes[0], wk) and torch.equal(planes[1], wi)
    pb, tot = adm.finish()
    jpb, jtot = _drive_jax(hi, lo, bounds, jspec, True)
    assert list(pb) == list(jpb) == want[0]
    assert tot == jtot == want[1]


@pytest.mark.parametrize("chunk", ["default", "small"])
@pytest.mark.parametrize("use_bloom", [True, False])
def test_budget_trips_every_block(chunk, use_bloom, monkeypatch):
    """budget_bytes=1 compacts after every block, pending lanes only or
    (a 256-lane chunk) a ladder run and a tail; no total changes."""
    _set_chunk(monkeypatch, chunk, 1 << 8)
    rng = np.random.default_rng(7 + (chunk == "small"))
    hi, lo = _rand_planes(rng, 5000, 800)
    bounds = [1700, 3400, 5000]
    jspec, tspec = _specs(14, use_bloom)
    want = _oracle(hi, lo, bounds, jspec, use_bloom)
    adm = _drive_port(hi, lo, bounds, tspec, use_bloom, block=333, budget=1)
    assert adm.fs.trips == len(list(_blocks(5000, bounds, 333)))
    pb, tot = adm.finish()
    assert (list(pb), tot) == (want[0], want[1])


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_fp_unpacked_fallback(chunk, monkeypatch):
    """_pack_ok False: the (pos, verdict) planes return to probe order by
    a scatter instead of the packed plane's sort; same totals, with the
    lanes pending to the end or merged up the ladder."""
    _set_chunk(monkeypatch, chunk)
    monkeypatch.setattr(TA, "_pack_ok", lambda m, nh: False)
    rng = np.random.default_rng(5)
    n = 7001
    hi, lo = _rand_planes(rng, n, 950)
    bounds = [2345, 5678, n]
    jspec, tspec = _specs(14, True)
    want = _oracle(hi, lo, bounds, jspec, True)
    pb, tot = _drive_port(hi, lo, bounds, tspec, True).finish()
    assert (list(pb), tot) == (want[0], want[1])
    keys_, idx = _first2_of(hi, lo)
    assert len(TA._fp_sort(keys_, idx, tspec)) == 2


def test_fp_sort_packed_entries_match_jax():
    """Part A's verdict of every probe of every key's start lane equals
    the JAX package's on the same first-2 planes (the entries of other
    lanes are never read, and the two packages order them differently)."""
    rng = np.random.default_rng(9)
    n = 5000
    hi, lo = _rand_planes(rng, n, 700)
    idx = np.arange(n, dtype=np.uint32)
    jspec, tspec = _specs(14, True)
    jh, jl, ji, nk = JA._first2_compact(jnp.asarray(hi), jnp.asarray(lo),
                                        jnp.asarray(idx))
    nk = int(nk)
    tk, ti = _first2_of(hi, lo, torch.from_numpy(idx.astype(np.int64)))
    assert torch.equal(tk, _port_keys(np.asarray(jh)[:nk],
                                      np.asarray(jl)[:nk]))
    assert np.array_equal(ti.numpy(), np.asarray(ji)[:nk])
    (jent,) = JA._fp_sort(jh[:nk], jl[:nk], ji[:nk], jspec)
    (tent,) = TA._fp_sort(tk, ti, tspec)
    want = (np.sort(np.asarray(jent)) & 1).astype(np.int64)
    got = (torch.sort(tent).values & 1).numpy()
    starts, _ = TA._first2_meta(tk, ti)
    read = starts.repeat(4).numpy()
    assert read.sum() > 1000 and 0 < want[read].sum() < read.sum()
    assert np.array_equal(got[read], want[read])


def test_stream_chunk_sort_is_key_idx_order():
    """A stable key sort of a chunk whose index rises is the (key, idx)
    order."""
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.integers(0, 50, 4000))
    i = torch.arange(4000)
    sk, si = TA._sort_by_key(k, i)
    order = np.lexsort((i.numpy(), k.numpy()))
    assert torch.equal(sk, k[order]) and torch.equal(si, i[order])


def test_lane_index_guard():
    adm = TA.DeferredYakAdmission(None, False)
    adm._base = (1 << 32) - (1 << 20)
    with pytest.raises(RuntimeError, match="KMER_TPU_FAST_YAK"):
        adm.add_block(torch.full((1 << 21,), keys.SENT), batch_end=True)


def test_pad_bounds_and_empty():
    assert TA._pad_bounds([5, 9]).tolist() == [5, 9] + [TA.IDX_SENT] * 30
    with pytest.raises(ValueError):
        TA._pad_bounds(list(range(9000)))
    adm = TA.DeferredYakAdmission(bloom.BloomSpec(4, 14, 4), True)
    adm.add_block(torch.full((100,), keys.SENT), batch_end=True)
    # the lane base counts every lane of a block, sentinels included
    assert adm._base == 100 and adm.bounds == [100]
    pb, tot = adm.finish()
    assert list(pb) == [0] and tot == 0


# -- bloom gate and tap -------------------------------------------------

@pytest.mark.parametrize("pre,bf_shift,n_hash", [
    (10, 0, 4), (10, 19, 4), (10, 20, 3), (10, 37, 4), (25, 37, 4),
    (10, 18, 4), (10, 22, 0)])
def test_make_bloom_matches_jax(pre, bf_shift, n_hash, capsys):
    from kmer_tpu.pipeline import yak as JY
    from kmer_tpu_torch.pipeline import yak as TY

    use, bf, spec, _bits, _exact = JY._make_bloom(pre, bf_shift, n_hash,
                                                  make_bits_array=False)
    want_err = capsys.readouterr().err
    tuse, tbf, tspec, tbits, texact = TY._make_bloom(
        pre, bf_shift, n_hash, make_bits_array=False)
    assert capsys.readouterr().err == want_err
    assert (tuse, tbf, tbits, texact) == (use, bf, None, _exact)
    assert (tspec is None) == (spec is None)
    if spec is not None:
        assert tuple(tspec) == tuple(spec)


def test_sim_tap_matches_jax_tap(monkeypatch):
    """YakSimTap on the same blocks as the JAX YakSimTap: the same log
    calls (batch sequence counts and running totals)."""
    from kmer_tpu.pipeline import yak as JY
    from kmer_tpu_torch.pipeline import yak as TY

    monkeypatch.setenv("KMER_TPU_TAP_BUDGET", "30000")
    rng = np.random.default_rng(12)
    hi, lo = _rand_planes(rng, 6000, 900)
    logs = ([], [])
    taps = (JY.YakSimTap(pre=4, bf_shift=14, log=lambda *a: logs[0].append(a)),
            TY.YakSimTap(pre=4, bf_shift=14, device="cpu",
                         log=lambda *a: logs[1].append(a)))
    for t in taps:
        t.begin_batches()
    for j, start in enumerate(range(0, 6000, 1000)):
        h, l_ = hi[start:start + 1000], lo[start:start + 1000]
        taps[0].ingest_planes(jnp.asarray(h), jnp.asarray(l_), None, 10 + j,
                              j % 2 == 1)
        taps[1].ingest_planes(_port_keys(h, l_), None, 10 + j, j % 2 == 1)
    for t in taps:
        t.finish_batches()
    assert logs[0] == logs[1] and len(logs[1]) == 3
    assert taps[1].tot == taps[0].tot
    assert taps[1].budget_trips > 0
