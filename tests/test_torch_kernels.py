"""The port's kernel modules (kmer_tpu_torch.kernels) against the JAX
package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
(Pallas kernels in interpret mode, as tests/test_pallas_kernels.py and
tests/test_bitonic.py run them) and through the port's plain PyTorch
version.  Every output is an integer, so every comparison is exact
(tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from kmer_tpu_torch.kernels import extract, keys, merge, seghist
from kmer_tpu_torch.kernels.encode import encode_bases
from kmer_tpu_torch.kernels.hash64 import HASH64_K32_ZERO, hash64, hash64_int

U64_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _dirty_block(rng, n, bad=0.02):
    """Mostly ACGT with N, lowercase, NUL and 'x' mixed in."""
    alphabet = np.frombuffer(b"ACGTacgtN\x00x", np.uint8)
    good = (1.0 - bad) / 8
    p = [good] * 8 + [bad / 3] * 3
    return rng.choice(alphabet, size=n, p=p)


def _jax_keys(hi, lo):
    return keys.from_hi_lo(np.asarray(hi), np.asarray(lo))


# -- key layout ---------------------------------------------------------

def test_keys_round_trip_and_order():
    rng = np.random.default_rng(0)
    n = 5000
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0, 0, 0xFFFFFFFF, 0x80000000]
    lo[:4] = [0, 1, 0xFFFFFFFE, 0]
    hi[-7:] = 0xFFFFFFFF
    lo[-7:] = 0xFFFFFFFF
    t = keys.from_hi_lo(hi, lo)
    assert t.dtype == torch.int64
    h2, l2 = keys.to_hi_lo(t)
    assert np.array_equal(h2, hi) and np.array_equal(l2, lo)
    # signed order of the biased plane == unsigned (hi, lo) order
    u = (hi.astype(np.uint64) << np.uint64(32)) | lo
    order = np.argsort(u, kind="stable")
    s = torch.sort(t, stable=True)
    assert np.array_equal(s.indices.numpy(), order)
    # the all-ones sentinel is INT64_MAX and sorts last
    assert int(keys.from_u64(np.array([U64_SENT]))[0]) == keys.SENT
    assert (s.values[-7:] == keys.SENT).all()
    assert (s.values[:-7] < keys.SENT).all()


def test_keys_k32_constant():
    """k=32 keys collapse to hash64(0) under the full mask; the bias
    keeps it in order whether or not its top bit is set."""
    from kmer_tpu.kernels import hash64 as jh, u64

    want = u64.to_np(jh.hash64(u64.from_int(0, (1,)), 64))[0]
    assert int(want) == HASH64_K32_ZERO == hash64_int(0, 64)
    b = keys.from_u64(np.array([want, U64_SENT, 0], np.uint64))
    assert b[2] < b[0] < b[1]


@pytest.mark.parametrize("k", [1, 15, 21, 31])
def test_hash64_matches_jax(k):
    from kmer_tpu.kernels import hash64 as jh, u64

    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << (2 * k), 4096, dtype=np.uint64)
    x[:2] = [0, (1 << (2 * k)) - 1]
    want = u64.to_np(jh.hash64(u64.from_np(x), 2 * k))
    got = hash64(torch.from_numpy(x.astype(np.int64)), 2 * k)
    assert np.array_equal(got.numpy().astype(np.uint64), want)


def test_encode_matches_jax():
    from kmer_tpu.kernels.encode import encode_bases as jax_encode

    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_encode(jnp.asarray(x)))
    got = encode_bases(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


# -- extraction ---------------------------------------------------------

@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_extract_plain_matches_pallas_interpret(k):
    from kmer_tpu.kernels.extract_tpu import extract_hashed_tpu

    block = _dirty_block(np.random.default_rng(100 + k), 512 * 128 * 2)
    with pltpu.force_tpu_interpret_mode():
        hi, lo, nk = extract_hashed_tpu(jnp.asarray(block), k, tile_rows=512)
    got, n_valid = extract.extract_keys_plain(torch.from_numpy(block), k)
    assert torch.equal(got, _jax_keys(hi, lo))
    assert int(n_valid) == int(nk) > 0
    # the CPU wrapper is the plain version
    got2, _ = extract.extract_keys(torch.from_numpy(block), k)
    assert torch.equal(got2, got)


@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_extract_steps_match_jax(k):
    """Flat and uniform-row steps vs kmer_tpu.pipeline.counter's."""
    from kmer_tpu.pipeline import counter as jc
    from kmer_tpu_torch.pipeline import counter as tc

    rng = np.random.default_rng(200 + k)
    flat = _dirty_block(rng, 30_000)
    hi, lo, nk = jc._extract_step(jnp.asarray(flat), k)
    keys_t, nk_t = extract.extract_keys(torch.from_numpy(flat), k)
    assert torch.equal(keys_t, _jax_keys(hi, lo))
    assert int(nk_t) == int(nk)

    L, n_rows = 151, 300
    buf = np.zeros(1 << 16, np.uint8)
    rows = np.zeros((n_rows, L + 1), np.uint8)
    rows[:, :L] = _dirty_block(rng, n_rows * L).reshape(n_rows, L)
    buf[: rows.size] = rows.reshape(-1)
    hi, lo, nk = jc._extract_step_rows(jnp.asarray(buf), k, L + 1)
    keys_t, nk_t = tc._extract_step_rows(torch.from_numpy(buf), k, L + 1)
    assert torch.equal(keys_t, _jax_keys(hi, lo))
    assert int(nk_t) == int(nk)


@pytest.mark.parametrize("read_len", [150, 99])
@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_extract_keys_rows_matches_jax(k, read_len):
    """extract_keys_rows (the CPU wrapper and the plain version) against
    kmer_tpu.pipeline.counter._extract_step_rows: the row-sliced plane
    and the valid count over the whole block, with a ragged tail of
    bases past the last whole row (valid windows there count, but are
    not written)."""
    from kmer_tpu.pipeline import counter as jc

    rng = np.random.default_rng(300 + k + read_len)
    rb, n_rows = read_len + 1, 257
    rows = np.zeros((n_rows, rb), np.uint8)
    rows[:, :read_len] = _dirty_block(rng, n_rows * read_len, bad=0.01) \
        .reshape(n_rows, read_len)
    tail = np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTAC",
                         np.uint8)[: rb - 1]
    buf = np.concatenate([rows.reshape(-1), tail])
    hi, lo, nk = jc._extract_step_rows(jnp.asarray(buf), k, rb)
    for fn in (extract.extract_keys_rows, extract.extract_keys_rows_plain):
        got, n_valid = fn(torch.from_numpy(buf), k, rb)
        assert got.shape == (n_rows * (rb - k),)
        assert torch.equal(got, _jax_keys(hi, lo))
        assert int(n_valid) == int(nk)
    flat, n_flat = extract.extract_keys_plain(torch.from_numpy(buf), k)
    assert int(n_flat) == int(nk) > int((got != keys.SENT).sum())


def test_extract_refuses_bad_input():
    x = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        extract.extract_keys_rows(x, 31, 31)
    with pytest.raises(ValueError):
        extract.extract_keys_rows_plain(x, 0, 40)
    with pytest.raises(ValueError):
        extract.extract_keys_rows(x.int(), 21, 40)


# -- segment histogram --------------------------------------------------

def _sorted_planes(rng, n, n_real, n_keys=4000):
    u = np.sort(rng.integers(0, n_keys, size=n_real, dtype=np.uint64)
                * np.uint64(2654435761))
    hi = np.full(n, 0xFFFFFFFF, np.uint32)
    lo = np.full(n, 0xFFFFFFFF, np.uint32)
    hi[:n_real] = (u >> np.uint64(32)).astype(np.uint32)
    lo[:n_real] = u.astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bins_cfg", [(256, None, 1), (256, 255, 2),
                                      (1024, 1023, 2)])
@pytest.mark.parametrize("sent_tail", [True, False])
def test_seghist_plain_matches_pallas_interpret(weighted, bins_cfg,
                                               sent_tail):
    from kmer_tpu.kernels.seghist import segment_bins_sorted

    rng = np.random.default_rng(bins_cfg[0] + 2 * weighted + sent_tail)
    n = 512 * 128 * 2
    hi, lo = _sorted_planes(rng, n, n - 5555 if sent_tail else n, 300)
    # weights as uint32: some past 2^31 so int32 sums wrap as on the TPU
    w = rng.integers(1, 7, size=n).astype(np.uint32)
    w[rng.random(n) < 0.01] = 0xFFFFFFF0
    with pltpu.force_tpu_interpret_mode():
        jb, jf = segment_bins_sorted(
            jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(w) if weighted else None, weighted=weighted,
            tile_rows=512, bins_cfg=bins_cfg)
    tw = torch.from_numpy(w.view(np.int32)) if weighted else None
    bins, final = seghist.segment_bins_sorted_plain(
        keys.from_hi_lo(hi, lo), tw, bins_cfg)
    assert bins.dtype == (torch.uint8 if bins_cfg[0] <= 256 else torch.int16)
    assert np.array_equal(bins.numpy().astype(np.int64),
                          np.asarray(jb).astype(np.int64))
    jf = np.asarray(jf)
    want_key = keys.from_hi_lo(np.array([jf[0]], np.int32).view(np.uint32),
                               np.array([jf[1]], np.int32).view(np.uint32))
    assert int(final[0]) == int(want_key[0])
    assert int(final[1]) == int(jf[2])
    assert (int(final[0]) == keys.SENT) == sent_tail


@pytest.mark.parametrize("n", [1 << 17, 1 << 18])
@pytest.mark.parametrize("bins_cfg", [(256, None, 1), (256, 255, 2),
                                      (1024, 1023, 2)])
@pytest.mark.parametrize("has_counts", [False, True])
@pytest.mark.parametrize("tail", ["sent", "none", "all_equal"])
def test_segment_hist_matches_jax_hist_impl(n, bins_cfg, has_counts, tail):
    """segment_hist_sorted (plain, and the CPU wrapper) against JAX
    `_hist_impl_tpu` (the Pallas seghist in interpret mode, then its
    histogram and final-run fold): pre-sorted raw keys, and unsorted
    counted runs (weights past 2^31, so int32 sums wrap), sorted here as
    the compactor sorts them.  Exact."""
    from kmer_tpu.table.compactor import _hist_impl_tpu

    from kmer_tpu_torch.table.compactor import _sort

    n_bins, max_count, min_keep = bins_cfg
    rng = np.random.default_rng(n + n_bins + 7 * has_counts + len(tail))
    if tail == "all_equal":  # one segment over every lane (k = 32)
        hi = np.full(n, 0x77CFA1EE, np.uint32)
        lo = np.full(n, 0xF01BCA90, np.uint32)
    else:
        hi, lo = _sorted_planes(rng, n, n - 5555 if tail == "sent" else n,
                                300)
    c = rng.integers(1, 7, size=n).astype(np.uint32)
    c[rng.random(n) < 0.01] = 0xFFFFFFF0
    if has_counts:  # counted runs arrive unsorted
        perm = rng.permutation(n)
        hi, lo, c = hi[perm], lo[perm], c[perm]
    with pltpu.force_tpu_interpret_mode():
        want, want_nd = _hist_impl_tpu(
            jnp.asarray(hi), jnp.asarray(lo),
            jnp.asarray(c) if has_counts else None, n_bins=n_bins,
            max_count=max_count, min_keep=min_keep, has_counts=has_counts,
            pre_sorted=not has_counts)
    k = keys.from_hi_lo(hi, lo)
    w = torch.from_numpy(c.view(np.int32)) if has_counts else None
    if has_counts:
        k, w = _sort(k, w)
    for fn in (seghist.segment_hist_sorted_plain, seghist.segment_hist_sorted):
        hist, nd = fn(k, w, bins_cfg)
        assert hist.dtype == torch.int64 and hist.shape == (n_bins,)
        assert np.array_equal(hist.numpy(), np.asarray(want).astype(np.int64))
        assert int(nd) == int(want_nd) == int(hist[1:].sum())
    if tail == "all_equal" and not has_counts:
        assert int(nd) == 1


# segment totals at the edges of the uint32 count width, and below them
U32_EDGES = (1 << 31, 0x90000000, (1 << 32) - 1, 1 << 32, (1 << 32) + 3,
             (1 << 31) - 1, 5)


def _edge_plane(rng, final, n=512 * 128 * 2):
    """Sorted (hi, lo) uint32 planes and uint32 weights of n lanes: short
    segments of small weights, each edge total three times in a segment
    of 2-4 lanes of random uint32 weights, the edge after `final` in a
    segment of 300 lanes across the Pallas tile edge at lane 65536, and a
    final open run with total
    `final` (or a sentinel tail when `final` is None, whose own total
    lies in [2^31, 2^32) and must never count)."""
    lens, totals = [], []
    edges = [t for t in U32_EDGES for _ in range(3)]
    rng.shuffle(edges)
    marks = sorted(rng.integers(0, n - 2000, size=len(edges)).tolist())
    pos, cross = 0, U32_EDGES[(U32_EDGES.index(final) + 1) % len(U32_EDGES)
                              if final is not None else 0]

    def seg(length, total=None):
        lens.append(length)
        totals.append(total)
        return pos + length

    while pos < n - 1000:
        if pos > 65536 - 400 and cross is not None:
            pos = seg(65536 - 150 - pos)  # background up to the crossing
            pos, cross = seg(300, cross), None
        elif marks and pos >= marks[0]:
            marks.pop(0)
            pos = seg(int(rng.integers(2, 5)), edges.pop())
        else:
            pos = seg(int(rng.integers(1, 9)))
    assert not edges and cross is None
    seg(n - pos, final if final is not None else 0xC0000000)
    w = np.empty(n, np.uint64)
    at = 0
    for length, total in zip(lens, totals):
        if total is None:
            w[at:at + length] = rng.integers(1, 7, size=length)
        else:
            r = rng.integers(0, 1 << 32, size=length, dtype=np.uint64)
            r[-1] = (total - int(r[:-1].sum())) % (1 << 32)
            w[at:at + length] = r
        at += length
    u = np.repeat(np.arange(len(lens), dtype=np.uint64)
                  * np.uint64(2654435761), lens)
    if final is None:
        u[-lens[-1]:] = U64_SENT
    return ((u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32),
            w.astype(np.uint32))


def _u32_model(u, w, bins_cfg):
    """numpy, uint32 arithmetic: each lane's bin (of the segment that
    ended at the lane before, as _hist_xla_core bins a total), the
    segments' uint32 totals and whether each is a sentinel's."""
    n_bins, max_count, min_keep = bins_cfg
    starts = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    tot = np.add.reduceat(w.astype(np.uint64), starts) & np.uint64(0xFFFFFFFF)
    b = np.where(tot >= min_keep, np.minimum(
        tot, min(max_count or n_bins, n_bins - 1)), 0)
    b[u[starts] == U64_SENT] = 0
    bins = np.zeros(u.size, np.int64)
    bins[starts[1:]] = b[:-1]
    return bins, tot.astype(np.int64), u[starts] == U64_SENT


@pytest.mark.parametrize("final", [*U32_EDGES, None])
@pytest.mark.parametrize("bins_cfg", [(256, None, 1), (256, 255, 2),
                                      (1024, 1023, 2)])
def test_segment_hist_u32_totals_match_xla(final, bins_cfg):
    """Weighted totals at 2^31, 0x90000000, 2^32 - 1, 2^32 (wraps to 0),
    2^32 + 3 (bin 3) and below 2^31, in short segments, across the Pallas
    tile edge and as the final open run: the port's per-lane bins and
    final run == a numpy uint32 model, its histogram (plain and the CPU
    wrapper) == JAX `_hist_impl` (the XLA form, which reads the totals as
    uint32).  JAX's Pallas form (interpret) sums int32 and drops exactly
    the segments whose total lies in [2^31, 2^32): its lanes differ from
    the model there and nowhere else, and its histogram lacks them in
    the last bin.  Exact."""
    from kmer_tpu.kernels.seghist import segment_bins_sorted
    from kmer_tpu.table.compactor import _hist_impl, _hist_impl_tpu

    n_bins, max_count, min_keep = bins_cfg
    rng = np.random.default_rng(n_bins + min_keep + U32_EDGES.index(final)
                                if final is not None else n_bins)
    hi, lo, w = _edge_plane(rng, final)
    u = (hi.astype(np.uint64) << np.uint64(32)) | lo
    want_bins, tot, sent = _u32_model(u, w, bins_cfg)
    k = keys.from_hi_lo(hi, lo)
    tw = torch.from_numpy(w.view(np.int32))
    bins, fin = seghist.segment_bins_sorted_plain(k, tw, bins_cfg)
    assert np.array_equal(bins.numpy().astype(np.int64), want_bins)
    assert int(fin[0]) == int(k[-1]) and int(fin[1]) == int(tot[-1])
    args = dict(n_bins=n_bins, max_count=max_count, min_keep=min_keep,
                has_counts=True)
    planes = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w))
    want, want_nd = _hist_impl(*planes, **args)
    want = np.asarray(want).astype(np.int64)
    for fn in (seghist.segment_hist_sorted_plain, seghist.segment_hist_sorted):
        hist, nd = fn(k, tw, bins_cfg)
        assert np.array_equal(hist.numpy(), want)
        assert int(nd) == int(want_nd)
    # the wide totals: in the last bin here, dropped by the Pallas form
    wide = (tot >= 1 << 31) & ~sent
    assert wide[:-1].sum() >= 9 and want[-1] >= wide.sum()
    with pltpu.force_tpu_interpret_mode():
        pb, pf = segment_bins_sorted(*planes, weighted=True, tile_rows=512,
                                     bins_cfg=bins_cfg)
        tpu, tpu_nd = _hist_impl_tpu(*planes, **args)
    ends = np.flatnonzero(np.r_[u[1:] != u[:-1], False]) + 1
    differ = np.zeros(u.size, bool)
    differ[ends[wide[:-1]]] = True
    assert np.array_equal(np.asarray(pb).astype(np.int64) != want_bins,
                          differ)
    assert int(np.asarray(pf)[2]) == int(np.int64(tot[-1]).astype(np.int32))
    drop = np.zeros(n_bins, np.int64)
    drop[-1] = wide.sum()
    assert np.array_equal(np.asarray(tpu).astype(np.int64), want - drop)
    assert int(tpu_nd) == int(want_nd) - wide.sum()


def test_segment_hist_small_cases():
    """n = 1, an all-sentinel plane, and a final run below min_keep."""
    one = torch.tensor([5], dtype=torch.int64)
    hist, nd = seghist.segment_hist_sorted(one, None, (256, None, 1))
    assert int(hist[1]) == 1 and int(nd) == 1
    hist, nd = seghist.segment_hist_sorted(one, None, (256, None, 2))
    assert int(nd) == 0 and int(hist.sum()) == 0
    sent = torch.full((1000,), keys.SENT, dtype=torch.int64)
    hist, nd = seghist.segment_hist_sorted(sent, None, (1024, 1023, 1))
    assert int(nd) == 0 and int(hist.sum()) == 0


def test_segment_hist_refuses_bad_input():
    x = torch.arange(8, dtype=torch.int64)
    bad = [(x.int(), None, (256, None, 1)), (x[:0], None, (256, None, 1)),
           (x.view(2, 4), None, (256, None, 1)),
           (x, torch.ones(8, dtype=torch.int64), (256, None, 1)),
           (x, torch.ones(7, dtype=torch.int32), (256, None, 1)),
           (x, None, (0, None, 1)), (x, None, ((1 << 15) + 1, None, 1)),
           (x, None, (256, None, 0)), (x, None, (256, 0, 1))]
    for k, w, cfg in bad:
        for fn in (seghist.segment_hist_sorted,
                   seghist.segment_hist_sorted_plain):
            with pytest.raises(ValueError):
                fn(k, w, cfg)


# -- merge path (the two-plane ladder's merge) --------------------------

def _dup_keys_u32(rng, n, sent=0.15):
    """(hi, lo) u32 planes of repeated 64-bit keys (a pool of n // 8)
    with a `sent` share of all-ones sentinel lanes."""
    pool = rng.integers(0, 1 << 64, max(2, n // 8), dtype=np.uint64)
    u = pool[rng.integers(0, pool.shape[0], n)]
    u[rng.random(n) < sent] = U64_SENT
    return (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)


@pytest.mark.parametrize("n", [16, 1 << 10, 1 << 18, 1 << 19, 1 << 20])
def test_merge_runs_plain_matches_pallas_interpret(n):
    """merge_runs_plain on the two sorted halves equals the JAX two-plane
    bitonic merge (`merge_sorted_halves`, Pallas interpret from 2^18
    lanes, its XLA stages below) lane for lane."""
    from kmer_tpu.kernels import bitonic as jb

    hi, lo = _dup_keys_u32(np.random.default_rng(n + 7), n)
    ch, cl = _sorted_halves_u32([hi, lo], n)
    mh, ml = jb.merge_sorted_halves(ch, cl, use_pallas=True)
    x = _jax_keys(ch, cl)
    a, b = x[: n // 2].clone(), x[n // 2:].clone()
    out = merge.merge_runs_plain(a, b)
    assert torch.equal(out, _jax_keys(mh, ml))
    # out of place: the runs are left as they were
    assert torch.equal(torch.cat([a, b]), x)
    # the CPU wrapper is the plain version
    assert torch.equal(merge.merge_runs(a, b), out)


def _merge_cases():
    rng = np.random.default_rng(21)
    big = rng.integers(-(1 << 63), 1 << 63, 5000, dtype=np.int64)
    small = rng.integers(-20, 20, 3000, dtype=np.int64)
    sent = np.full(700, keys.SENT, np.int64)
    return {
        "unequal": (big[:4093], big[4093:]),
        "dups_unequal": (small[:17], small[17:]),
        "a_empty": (big[:0], big[:999]),
        "b_empty": (big[:1234], big[:0]),
        "both_empty": (big[:0], big[:0]),
        "all_equal": (np.full(4096, 5, np.int64), np.full(4100, 5, np.int64)),
        "all_sentinel": (sent[:300], sent),
        "sentinel_tails": (np.concatenate([small[:900], sent[:100]]),
                           np.concatenate([big[:3], sent[:1]])),
        # equal power-of-two halves, as a bitonic merge takes them: one
        # lane each, 64 lanes of repeated keys, 2^12 lanes with 15%
        # sentinels (each half's sentinel tail), one key on every lane
        "pow2_one_lane": (small[:1], small[1:2]),
        "pow2_dups": (small[:64], small[64:128]),
        "pow2_sentinel_tails": tuple(
            np.where(rng.random(4096) < 0.15, keys.SENT, h)
            for h in (big[:4096], small[:2048].repeat(2))),
        "pow2_all_equal": (np.full(2048, -3, np.int64),
                           np.full(2048, -3, np.int64)),
    }


@pytest.mark.parametrize("case", list(_merge_cases()))
def test_merge_runs_plain_matches_numpy_sort(case):
    a, b = (np.sort(x) for x in _merge_cases()[case])
    want = np.sort(np.concatenate([a, b]), kind="stable")
    got = merge.merge_runs_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["unequal", "dups_unequal", "a_empty",
                                  "b_empty", "all_equal", "sentinel_tails"])
@pytest.mark.parametrize("tile", [1, 7, 4096])
def test_merge_partition_plain(case, tile):
    """The splits the CUDA partition writes: at each tile boundary d,
    the lanes of a among the first d merged lanes (ties to a), checked
    against a stable numpy argsort of the concatenation."""
    a, b = (np.sort(x) for x in _merge_cases()[case])
    n = a.shape[0] + b.shape[0]
    from_a = np.argsort(np.concatenate([a, b]), kind="stable") < a.shape[0]
    d = np.minimum(np.arange(0, -(-n // tile) + 1) * tile, n)
    want = np.concatenate([[0], np.cumsum(from_a)])[d]
    got = merge.merge_partition_plain(torch.from_numpy(a),
                                      torch.from_numpy(b), tile)
    assert np.array_equal(got.numpy(), want)


def test_merge_runs_refuses_bad_input():
    x = torch.arange(8, dtype=torch.int64)
    for a, b in ((x.int(), x), (x, x.float()), (x[::2], x),
                 (x, x.view(2, 4)), (x, x[1::2])):
        with pytest.raises(ValueError):
            merge.merge_runs(a, b)
        with pytest.raises(ValueError):
            merge.merge_runs_plain(a, b)
    # the kernels' wrappers take CUDA tensors only: merge_runs picks
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_partition(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_path(x, x, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("lanes", ["int32", "key_idx"])
def test_merge_runs_lane_types_refuse_bad_input(lanes):
    x = torch.arange(8, dtype=torch.int64)
    splits = torch.zeros(2, dtype=torch.int64)
    if lanes == "int32":
        y = x.int()
        for a, b in ((y, x), (x, y), (y, y.short()), (y[::2], y),
                     (y, y.view(2, 4))):  # a mix of dtypes, strides, shapes
            with pytest.raises(ValueError):
                merge.merge_runs(a, b)
            with pytest.raises(ValueError):
                merge.merge_runs_plain(a, b)
        with pytest.raises(ValueError, match="CUDA"):
            merge.merge_partition(y, y)
        with pytest.raises(ValueError, match="CUDA"):
            merge.merge_path(y, y, splits)
        return
    for planes in ((x, x.int(), x, x), (x, x, x.int(), x), (x, x[:4], x, x),
                   (x, x, x, x[:4]), (x[::2], x[::2], x, x),
                   (x.view(2, 4), x.view(2, 4), x, x)):
        with pytest.raises(ValueError):
            merge.merge_runs3(*planes)
        with pytest.raises(ValueError):
            merge.merge_runs3_plain(*planes)
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_partition3(x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_path3(x, x, x, x, splits)


def _sorted_halves_u32(planes, n):
    """Sort each half of u32 planes lexicographically (all planes keys)."""
    half = n // 2
    out = [jax.lax.sort(tuple(jnp.asarray(p[a:a + half]) for p in planes),
                        num_keys=len(planes)) for a in (0, half)]
    return [jnp.concatenate([h0, h1]) for h0, h1 in zip(*out)]


def test_one_plane_narrow_widen():
    """The one-plane layout: data keys < 2^30 as int32, the sentinel as
    INT32_MAX (the JAX u32 0xFFFFFFFF would be -1 and sort first)."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, 1 << 30, 3000, dtype=np.uint64)
    u[:3] = [0, (1 << 30) - 1, 0xFFFFFFFFFFFFFFFF]
    b = torch.from_numpy(keys.from_u64(u))
    x = keys.narrow(b)
    assert x.dtype == torch.int32
    assert int(x[2]) == keys.SENT32 == (1 << 31) - 1
    assert np.array_equal(x[3:].numpy(), u[3:].astype(np.int32))
    assert torch.equal(keys.widen(x), b)
    assert torch.equal(torch.sort(x).indices, torch.sort(b).indices)


# -- merge path on the one-plane and (key, index) ladders ---------------

@pytest.mark.parametrize("n", [1 << 18, 1 << 19])
def test_merge_runs_plain_int32_matches_pallas_interpret(n):
    """merge_runs_plain on int32 halves (20% sentinels) equals the JAX
    one-plane merge (`merge_sorted_halves1`, Pallas interpret) lane for
    lane; out of place, and the CPU wrapper is the plain version."""
    from kmer_tpu.kernels import bitonic as jb

    rng = np.random.default_rng(n + 11)
    lo = rng.integers(0, 1 << 30, n, dtype=np.uint64).astype(np.uint32)
    lo[rng.random(n) < 0.2] = 0xFFFFFFFF
    (cl,) = _sorted_halves_u32([lo], n)
    ml = np.asarray(jb.merge_sorted_halves1(cl, use_pallas=True))
    x = keys.narrow(keys.from_hi_lo(np.where(np.asarray(cl) == 0xFFFFFFFF,
                                             0xFFFFFFFF, 0), np.asarray(cl)))
    a, b = x[: n // 2].clone(), x[n // 2:].clone()
    out = merge.merge_runs_plain(a, b)
    assert out.dtype == torch.int32
    want = np.where(ml == 0xFFFFFFFF, keys.SENT32, ml).astype(np.int32)
    assert np.array_equal(out.numpy(), want)
    assert torch.equal(torch.cat([a, b]), x)
    assert torch.equal(merge.merge_runs(a, b), out)


@pytest.mark.parametrize("n", [1 << 17, 1 << 18])
def test_merge_runs3_plain_matches_pallas_interpret(n):
    """merge_runs3_plain on (key, index) halves equals the JAX
    three-plane merge (`merge_sorted_halves3`, Pallas interpret): repeated
    keys, so the index decides ties, high indices, 15% sentinel lanes."""
    from kmer_tpu.kernels import bitonic as jb

    rng = np.random.default_rng(n + 13)
    pool = rng.integers(0, 1 << 40, 2000, dtype=np.uint64)
    u = pool[rng.integers(0, 2000, n)]
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = u.astype(np.uint32)
    idx = rng.permutation(n).astype(np.uint32)
    idx[: n // 4] += np.uint32((1 << 32) - (1 << 26) - n)  # high indices
    m = rng.random(n) < 0.15
    hi[m], lo[m], idx[m] = 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF
    ch, cl, cx = _sorted_halves_u32([hi, lo, idx], n)
    mh, ml, mx = jb.merge_sorted_halves3(ch, cl, cx, use_pallas=True)
    k = _jax_keys(ch, cl)
    i = torch.from_numpy(np.asarray(cx).astype(np.int64))
    half = n // 2
    planes = [k[:half].clone(), i[:half].clone(), k[half:].clone(),
              i[half:].clone()]
    ok, oi = merge.merge_runs3_plain(*planes)
    assert torch.equal(ok, _jax_keys(mh, ml))
    assert np.array_equal(oi.numpy(), np.asarray(mx).astype(np.int64))
    # out of place, and the CPU wrapper is the plain version
    assert torch.equal(torch.cat(planes[::2]), k)
    assert torch.equal(torch.cat(planes[1::2]), i)
    wk, wi = merge.merge_runs3(*planes)
    assert torch.equal(wk, ok) and torch.equal(wi, oi)


@pytest.mark.parametrize("case", list(_merge_cases()))
def test_merge_runs_plain_int32_matches_numpy_sort(case):
    """The int64 edge cases folded into int32 lanes (the sentinel becomes
    INT32_MAX, the rest their low 30 bits)."""
    a, b = (np.sort(np.where(x == keys.SENT, keys.SENT32,
                             x & ((1 << 30) - 1)).astype(np.int32))
            for x in _merge_cases()[case])
    want = np.sort(np.concatenate([a, b]), kind="stable")
    got = merge.merge_runs_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(merge.merge_runs(torch.from_numpy(a),
                                        torch.from_numpy(b)), got)


IDX_SENT = (1 << 63) - 1  # the tap's pad index (pipeline/yak_admit.py)


def _merge3_cases():
    """(key_a, idx_a, key_b, idx_b) runs, each (key, index)-sorted: the
    one-plane edge cases with a random unique index, then the cases where
    the index decides."""
    rng = np.random.default_rng(22)
    out = {}
    for name, (a, b) in _merge_cases().items():
        idx = rng.permutation(a.shape[0] + b.shape[0]).astype(np.int64)
        idx[::3] += (1 << 32) - (1 << 26) - idx.shape[0]  # high indices
        out[name] = (a, idx[: a.shape[0]], b, idx[a.shape[0]:])
    # one key on every lane (the k = 32 plane), the indices interleaved
    # between the runs lane by lane and in blocks
    n = 9001
    idx = np.arange(n, dtype=np.int64)
    key = np.full(n, 7, np.int64)
    out["all_equal_interleaved"] = (key[::2], idx[::2], key[1::2], idx[1::2])
    in_a = (idx // 700) % 2 == 0
    out["all_equal_blocks"] = (key[in_a], idx[in_a], key[~in_a], idx[~in_a])
    # invalid lanes (SENT, real index) among (SENT, IDX_SENT) pads
    sent = np.full(n, keys.SENT, np.int64)
    sidx = np.where(rng.random(n) < 0.5, idx, IDX_SENT)
    out["sentinels_with_indices"] = (sent[:5000], sidx[:5000], sent[5000:],
                                     sidx[5000:])
    small = rng.integers(0, 5, n)
    small[rng.random(n) < 0.2] = keys.SENT
    pad = np.full(300, IDX_SENT, np.int64)
    out["data_invalid_pads"] = (
        np.concatenate([small[:6000], sent[:300]]),
        np.concatenate([idx[:6000], pad]),
        np.concatenate([small[6000:], sent[:300]]),
        np.concatenate([idx[6000:], pad]))
    return out


def _sorted3(key, idx):
    order = np.lexsort((idx, key))
    return key[order], idx[order]


@pytest.mark.parametrize("case", list(_merge3_cases()))
def test_merge_runs3_plain_matches_numpy_lexsort(case):
    ka, ia, kb, ib = _merge3_cases()[case]
    (ka, ia), (kb, ib) = _sorted3(ka, ia), _sorted3(kb, ib)
    wk, wi = _sorted3(np.concatenate([ka, kb]), np.concatenate([ia, ib]))
    planes = [torch.from_numpy(x) for x in (ka, ia, kb, ib)]
    gk, gi = merge.merge_runs3_plain(*planes)
    assert gk.dtype == gi.dtype == torch.int64
    assert np.array_equal(gk.numpy(), wk) and np.array_equal(gi.numpy(), wi)
    ck, ci = merge.merge_runs3(*planes)  # the CPU wrapper
    assert torch.equal(ck, gk) and torch.equal(ci, gi)


@pytest.mark.parametrize("case", ["unequal", "dups_unequal", "a_empty",
                                  "b_empty", "all_equal_interleaved",
                                  "all_equal_blocks",
                                  "sentinels_with_indices",
                                  "data_invalid_pads"])
@pytest.mark.parametrize("tile", [1, 7, 2048])
def test_merge_partition3_plain(case, tile):
    """The splits the (key, index) partition writes, against a numpy
    lexsort of the concatenation with a's lanes first among identical
    ones."""
    ka, ia, kb, ib = _merge3_cases()[case]
    (ka, ia), (kb, ib) = _sorted3(ka, ia), _sorted3(kb, ib)
    n = ka.shape[0] + kb.shape[0]
    from_b = np.arange(n) >= ka.shape[0]
    order = np.lexsort((from_b, np.concatenate([ia, ib]),
                        np.concatenate([ka, kb])))
    d = np.minimum(np.arange(0, -(-n // tile) + 1) * tile, n)
    want = np.concatenate([[0], np.cumsum(~from_b[order])])[d]
    got = merge.merge_partition3_plain(
        *(torch.from_numpy(x) for x in (ka, ia, kb, ib)), tile)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["unequal", "dups_unequal", "all_equal",
                                  "sentinel_tails"])
@pytest.mark.parametrize("tile", [7, 8192])
def test_merge_partition_plain_int32(case, tile):
    a, b = (np.sort(np.where(x == keys.SENT, keys.SENT32,
                             x & ((1 << 30) - 1)).astype(np.int32))
            for x in _merge_cases()[case])
    n = a.shape[0] + b.shape[0]
    from_a = np.argsort(np.concatenate([a, b]), kind="stable") < a.shape[0]
    d = np.minimum(np.arange(0, -(-n // tile) + 1) * tile, n)
    want = np.concatenate([[0], np.cumsum(from_a)])[d]
    got = merge.merge_partition_plain(torch.from_numpy(a),
                                      torch.from_numpy(b), tile)
    assert np.array_equal(got.numpy(), want)
