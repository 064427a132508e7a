"""The port's CUDA kernels against their plain PyTorch versions on the
card, lane for lane, and the engine on the card against the engine on
the CPU.  These need an NVIDIA GPU (marker `cuda`) and skip elsewhere;
on a machine with one, run them with

    python -m pytest tests/test_torch_cuda.py -q

The inputs are integers and the outputs too: every comparison is exact.
"""

import gc
import os

import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels import extract, merge, seghist
from kmer_tpu_torch.kernels.keys import SENT, SENT32

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 5, 2047, 2049, 4096 * 3 + 17,
                               (1 << 20) + 3])
@pytest.mark.parametrize("k", list(range(1, 33)))
def test_extract_kernel_matches_plain(dev, n, k):
    """Both extract forms: the flat plane, and the row-sliced plane at two
    row widths, also from an input that is not 16-byte aligned."""
    rng = np.random.default_rng(n + k)
    alphabet = np.frombuffer(b"ACGTacgtN\x00x", np.uint8)
    x = torch.from_numpy(rng.choice(
        alphabet, size=n + 1, p=[0.12] * 8 + [0.04 / 3] * 3)).to(dev)
    for block in (x[:n], x[1:]):
        keys, nv = extract.extract_keys(block, k)
        want, nw = extract.extract_keys_plain(block, k)
        assert torch.equal(keys, want)
        assert int(nv) == int(nw)
        for row_bytes in (k + 1, 152):
            keys, nv = extract.extract_keys_rows(block, k, row_bytes)
            want, nw = extract.extract_keys_rows_plain(block, k, row_bytes)
            assert torch.equal(keys, want)
            assert int(nv) == int(nw)


def _sorted_keys(dev, n, seed, pool=600, sent=0.1):
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.sort(torch.randint(-pool // 2, pool // 2, (n,), generator=g,
                                    device=dev)).values
    if n > 10 and sent:
        keys[-int(n * sent):] = SENT
    return keys, g


_CFGS = [(256, None, 1), (1024, 1023, 2), (1 << 15, None, 1)]


@pytest.mark.parametrize("n", [1, 4095, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bins_cfg", _CFGS)
def test_seghist_kernel_matches_plain(dev, n, weighted, bins_cfg):
    keys, g = _sorted_keys(dev, n, n)
    w = (torch.randint(-5, 1 << 31, (n,), generator=g, device=dev,
                       dtype=torch.int32) if weighted else None)
    hist, nd = seghist.segment_hist_sorted(keys, w, bins_cfg)
    want, wnd = seghist.segment_hist_sorted_plain(keys, w, bins_cfg)
    assert torch.equal(hist, want)
    assert int(nd) == int(wnd)


@pytest.mark.parametrize("case", ["one_tile_plus", "over_1000_tiles",
                                  "all_equal", "all_sentinel", "many_ones",
                                  "ragged", "long_runs"])
@pytest.mark.parametrize("bins_cfg", _CFGS)
def test_seghist_kernel_tile_crossings(dev, case, bins_cfg):
    """Segments that cross tiles (4096 lanes): one longer than a tile,
    one longer than 1000 tiles, one over the whole plane (k = 32), an
    all-sentinel plane, almost every segment of length 1 (bin 1 under
    contention), a ragged n, and 2^24 lanes of 3000-lane runs (several
    tiles a block, runs crossing tiles and blocks); unweighted and
    weighted."""
    tile = 4096
    if case == "one_tile_plus":
        parts = [torch.arange(100), torch.full((tile + 77,), 100),
                 torch.arange(101, 5000)]
    elif case == "over_1000_tiles":
        parts = [torch.arange(50), torch.full((1000 * tile + 123,), 50),
                 torch.arange(51, 3000).repeat_interleave(3)]
    elif case == "all_equal":
        parts = [torch.full((300 * tile + 5,), -7)]
    elif case == "all_sentinel":
        parts = [torch.full((3 * tile + 1,), SENT)]
    elif case == "many_ones":
        parts = [torch.arange(20 * tile), torch.full((17,), SENT)]
    elif case == "ragged":
        parts = [torch.arange(7 * tile + 3).div(5, rounding_mode="floor")]
    else:
        parts = [torch.arange((1 << 24) + 5).div(3000, rounding_mode="floor"),
                 torch.full((999,), SENT)]
    keys = torch.cat(parts).to(torch.int64).to(dev)
    keys = torch.sort(keys).values
    g = torch.Generator(device=dev).manual_seed(len(case))
    for w in (None, torch.randint(-5, 1 << 31, keys.shape, generator=g,
                                  device=dev, dtype=torch.int32)):
        hist, nd = seghist.segment_hist_sorted(keys, w, bins_cfg)
        want, wnd = seghist.segment_hist_sorted_plain(keys, w, bins_cfg)
        assert torch.equal(hist, want) and int(nd) == int(wnd)


# weighted totals at the edges of the uint32 count width, and below them
_U32_EDGES = (1 << 31, 0x90000000, (1 << 32) - 1, 1 << 32, (1 << 32) + 3,
              (1 << 31) - 1, 5)


def _u32_plane(rng, case, tail):
    """Sorted int64 keys and int32 weights (uint32 bits) on the host whose
    segments' totals cycle through _U32_EDGES (every third segment small
    weights): segments of 2-40 lanes inside tiles, of 3,000-9,000 lanes
    across tiles (4096 lanes), or of 20,000-60,000 lanes with one of 1000
    tiles, several tiles a block of the persistent grid, across blocks.
    The last segment, the open final run, totals 0x90000000; under tail
    "sent" a sentinel tail of that total follows (it never counts)."""
    if case == "in_tile":
        lens = rng.integers(2, 41, size=600)
    elif case == "across_tiles":
        lens = rng.integers(3000, 9001, size=40)
    else:
        lens = np.r_[rng.integers(20_000, 60_001, size=150), 1000 * 4096,
                     rng.integers(20_000, 60_001, size=150)]
    lens = np.r_[lens, 777] if tail == "open" else np.r_[lens, 777, 5000]
    totals = [_U32_EDGES[i % len(_U32_EDGES)] if i % 3 else None
              for i in range(len(lens))]
    totals[-1] = totals[-2] = 0x90000000
    keys = np.repeat(np.arange(len(lens), dtype=np.int64) * 7 - 5000, lens)
    if tail == "sent":
        keys[-lens[-1]:] = SENT
    w = np.empty(keys.size, np.uint64)
    at = 0
    for length, total in zip(lens, totals):
        if total is None:
            w[at:at + length] = rng.integers(1, 7, size=length)
        else:
            r = rng.integers(0, 1 << 32, size=length, dtype=np.uint64)
            r[-1] = (total - int(r[:-1].sum())) % (1 << 32)
            w[at:at + length] = r
        at += length
    return (torch.from_numpy(keys),
            torch.from_numpy(w.astype(np.uint32).view(np.int32)))


def _u32_hist(keys, w, bins_cfg):
    """numpy: each segment's total mod 2^32 read as uint32 (as the JAX
    package's _hist_xla_core reads it), the sentinel's dropped, min_keep,
    max_count and n_bins - 1; (hist, n_distinct, totals past 2^31)."""
    n_bins, max_count, min_keep = bins_cfg
    k = keys.numpy()
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    tot = np.add.reduceat(w.numpy().view(np.uint32).astype(np.uint64),
                          starts) & np.uint64(0xFFFFFFFF)
    tot = tot[(k[starts] != SENT) & (tot >= min_keep)]
    top = n_bins - 1 if max_count is None else min(max_count, n_bins - 1)
    hist = np.bincount(np.minimum(tot, top).astype(np.int64),
                       minlength=n_bins)
    return hist, tot.size, int((tot >= 1 << 31).sum())


@pytest.mark.parametrize("case", ["in_tile", "across_tiles",
                                  "across_blocks"])
@pytest.mark.parametrize("tail", ["open", "sent"])
@pytest.mark.parametrize("bins_cfg", [(256, None, 1), (1024, 1023, 2),
                                      (2048, None, 1)])
def test_seghist_kernel_u32_totals(dev, case, tail, bins_cfg):
    """Weighted totals in [2^31, 2^32), exactly 2^32 and past it, in
    segments inside a tile, across tiles and across blocks (through
    stitch_tiles), and in the open final run; n_bins 1024 (the
    shared-memory histogram) and 2048 (global atomics): kernel == plain
    == the numpy uint32 model."""
    keys, w = _u32_plane(np.random.default_rng(len(case) + len(tail)),
                         case, tail)
    want, want_nd, wide = _u32_hist(keys, w, bins_cfg)
    assert wide >= 3 and want[-1] >= wide
    keys, w = keys.to(dev), w.to(dev)
    hist, nd = seghist.segment_hist_sorted(keys, w, bins_cfg)
    plain, pnd = seghist.segment_hist_sorted_plain(keys, w, bins_cfg)
    assert torch.equal(hist, plain) and int(nd) == int(pnd)
    assert np.array_equal(hist.cpu().numpy(), want) and int(nd) == want_nd


def test_seghist_refuses_bad_input(dev):
    x = torch.arange(8, device=dev)
    with pytest.raises(ValueError):
        seghist.segment_hist_sorted(x, torch.ones(8, dtype=torch.int32),
                                    (256, None, 1))
    with pytest.raises(ValueError):
        seghist.segment_hist_sorted(x[:0], None, (256, None, 1))


def _runs(dev, na, nb, seed, pool=None, sent=0.15):
    """Two ascending int64 runs of na and nb lanes (keys drawn from
    `pool` distinct values when given, so they repeat), with a `sent`
    share of SENT lanes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(-(1 << 62), 1 << 62, (pool or na + nb,), generator=g,
                      device=dev)
    if pool:
        v = v[torch.randint(0, pool, (na + nb,), generator=g, device=dev)]
    v[torch.rand(na + nb, generator=g, device=dev) < sent] = SENT
    return torch.sort(v[:na]).values, torch.sort(v[na:]).values


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 5), (5, 0), (1, 1),
                                   (4095, 1), (4096, 4096), (4097, 12345),
                                   (1 << 20, 1 << 20), (777_777, 12_345)])
@pytest.mark.parametrize("pool", [None, 100])
def test_merge_path_kernels_match_sort(dev, na, nb, pool):
    """merge_partition and merge_path (through merge_runs) against
    torch.sort of the concatenation and against their plain versions."""
    a, b = _runs(dev, na, nb, na + 3 * nb, pool)
    want = torch.sort(torch.cat([a, b])).values
    a0, b0 = a.clone(), b.clone()
    assert torch.equal(merge.merge_runs(a, b), want)
    assert torch.equal(a, a0) and torch.equal(b, b0)  # out of place
    assert torch.equal(merge.merge_runs_plain(a, b), want)
    if na + nb:
        assert torch.equal(merge.merge_partition(a, b),
                           merge.merge_partition_plain(a, b,
                                                       merge.tile_lanes()))


@pytest.mark.parametrize("case", ["all_equal", "all_sentinel", "one_long"])
def test_merge_path_kernels_edge_cases(dev, case):
    n = 3 * 4096 + 5
    if case == "all_equal":
        a, b = (torch.full((m,), 7, dtype=torch.int64, device=dev)
                for m in (n, n + 2))
    elif case == "all_sentinel":
        a, b = (torch.full((m,), SENT, dtype=torch.int64, device=dev)
                for m in (n, 100))
    else:  # every lane of b below every lane of a
        a = torch.arange(n, device=dev)
        b = torch.arange(n, 2 * n + 9, device=dev)
        a, b = b, a
    want = torch.sort(torch.cat([a, b])).values
    assert torch.equal(merge.merge_runs(a, b), want)


def test_merge_path_refuses_bad_input(dev):
    x = torch.arange(8, device=dev)
    with pytest.raises(ValueError):
        merge.merge_runs(x, x.cpu())
    with pytest.raises(ValueError):
        merge.merge_runs(x.int(), x)
    with pytest.raises(ValueError):
        merge.merge_runs(x[::2], x)


_SIZES = [(0, 0), (0, 5), (5, 0), (1, 1), (4095, 1), (8191, 1), (8192, 8192),
          (4097, 12345), (1 << 20, 1 << 20), (777_777, 12_345),
          (3, (1 << 19) + 11)]


def _runs1(dev, na, nb, seed, pool=None, sent=0.2):
    """Two ascending int32 runs of one-plane keys (< 2^30, repeated when
    drawn from `pool` values) with a `sent` share of SENT32 lanes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(0, pool or 1 << 30, (na + nb,), generator=g,
                      device=dev, dtype=torch.int32)
    v[torch.rand(na + nb, generator=g, device=dev) < sent] = SENT32
    return torch.sort(v[:na]).values, torch.sort(v[na:]).values


@pytest.mark.parametrize("na,nb", _SIZES)
@pytest.mark.parametrize("pool", [None, 100])
def test_merge_path1_kernels_match_sort(dev, na, nb, pool):
    """The int32 merge_partition and merge_path (through merge_runs)
    against torch.sort of the concatenation and their plain versions."""
    a, b = _runs1(dev, na, nb, na + 3 * nb + 1, pool)
    want = torch.sort(torch.cat([a, b])).values
    a0, b0 = a.clone(), b.clone()
    got = merge.merge_runs(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(a, a0) and torch.equal(b, b0)  # out of place
    assert torch.equal(merge.merge_runs_plain(a, b), want)
    if na + nb:
        assert torch.equal(
            merge.merge_partition(a, b),
            merge.merge_partition_plain(a, b, merge.tile_lanes(torch.int32)))


def _lexsort(key, idx):
    """(key, index) order of arbitrary lanes: by index, then stably by
    key."""
    idx, o = torch.sort(idx, stable=True)
    key, o = torch.sort(key[o], stable=True)
    return key, idx[o]


def _runs3(dev, na, nb, seed, pool=None, sent=0.15):
    """Two (key, index)-ascending runs: int64 keys (repeated when drawn
    from `pool` values) with a `sent` share of SENT lanes, and a unique
    index dealt at random between the runs, some near the top of the
    lane-index range."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = na + nb
    key = torch.randint(-(1 << 62), 1 << 62, (pool or n,), generator=g,
                        device=dev)
    if pool:
        key = key[torch.randint(0, pool, (n,), generator=g, device=dev)]
    key[torch.rand(n, generator=g, device=dev) < sent] = SENT
    idx = torch.randperm(n, generator=g, device=dev)
    idx[::3] += (1 << 32) - (1 << 26) - n
    return (*_lexsort(key[:na], idx[:na]), *_lexsort(key[na:], idx[na:]))


def _check_merge3(planes):
    want = _lexsort(torch.cat(planes[::2]), torch.cat(planes[1::2]))
    before = [p.clone() for p in planes]
    gk, gi = merge.merge_runs3(*planes)
    assert torch.equal(gk, want[0]) and torch.equal(gi, want[1])
    assert all(torch.equal(p, q) for p, q in zip(planes, before))
    pk, pi = merge.merge_runs3_plain(*planes)
    assert torch.equal(pk, want[0]) and torch.equal(pi, want[1])
    if gk.shape[0]:
        assert torch.equal(
            merge.merge_partition3(*planes),
            merge.merge_partition3_plain(*planes, merge.tile_lanes3()))


@pytest.mark.parametrize("na,nb", _SIZES)
@pytest.mark.parametrize("pool", [None, 100, 1])
def test_merge_path3_kernels_match_lexsort(dev, na, nb, pool):
    """The (key, index) merge_partition3 and merge_path3 (through
    merge_runs3) against a lexicographic sort of the concatenation and
    their plain versions; pool 1 is one key on every data lane, so the
    index decides every compare."""
    _check_merge3(_runs3(dev, na, nb, na + 3 * nb + 2, pool))


@pytest.mark.parametrize("case", ["one_key_interleaved", "one_key_blocks",
                                  "all_sentinel_mixed", "all_pads",
                                  "one_long", "ladder_shape"])
def test_merge_path3_kernels_edge_cases(dev, case):
    n = 5 * 4096 + 77
    i = torch.arange(n, device=dev)
    key = torch.full((n,), 7, dtype=torch.int64, device=dev)
    idx_sent = (1 << 63) - 1
    if case == "one_key_interleaved":  # the k = 32 plane, over many tiles
        planes = (key[::2], i[::2], key[1::2], i[1::2])
    elif case == "one_key_blocks":
        in_a = (i // 3000) % 2 == 0
        planes = (key[in_a], i[in_a], key[~in_a], i[~in_a])
    elif case == "all_sentinel_mixed":  # invalid lanes among pad lanes
        g = torch.Generator(device=dev).manual_seed(5)
        idx = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, i,
                          idx_sent)
        sent = torch.full_like(key, SENT)
        h = n // 3
        planes = (sent[:h], torch.sort(idx[:h]).values, sent[h:],
                  torch.sort(idx[h:]).values)
    elif case == "all_pads":
        sent = torch.full_like(key, SENT)
        pads = torch.full_like(key, idx_sent)
        planes = (sent[:100], pads[:100], sent, pads)
    elif case == "one_long":  # every lane of b below every lane of a
        planes = (i + n, i, i[: n - 9], i[: n - 9])
    else:  # a data run with a pad tail against a shorter padded run
        a = _runs3(dev, 1 << 16, 0, 3, pool=500)[:2]
        b = _runs3(dev, 5000, 0, 4, pool=500)[:2]
        pad = (1 << 16) - 5000
        planes = (*a, torch.cat([b[0], key.new_full((pad,), SENT)]),
                  torch.cat([b[1] + (1 << 20), key.new_full((pad,),
                                                             idx_sent)]))
    _check_merge3(tuple(p.contiguous() for p in planes))


@pytest.mark.parametrize("case", ["all_equal", "all_sentinel", "one_long"])
def test_merge_path1_kernels_edge_cases(dev, case):
    n = 3 * 8192 + 5
    if case == "all_equal":
        a, b = (torch.full((m,), 7, dtype=torch.int32, device=dev)
                for m in (n, n + 2))
    elif case == "all_sentinel":
        a, b = (torch.full((m,), SENT32, dtype=torch.int32, device=dev)
                for m in (n, 100))
    else:  # every lane of b below every lane of a
        b = torch.arange(n, device=dev, dtype=torch.int32)
        a = torch.arange(n, 2 * n + 9, device=dev, dtype=torch.int32)
    want = torch.sort(torch.cat([a, b])).values
    assert torch.equal(merge.merge_runs(a, b), want)
    # runs that start off the 16-byte grid (views one lane in)
    assert torch.equal(merge.merge_runs(a[1:], b[3:]),
                       torch.sort(torch.cat([a[1:], b[3:]])).values)


def test_merge_path_lane_types_refuse_bad_input(dev):
    x = torch.arange(8, device=dev)
    y = x.int()
    for a, b in ((y, x), (x, y), (y, y.cpu()), (y[::2], y)):
        with pytest.raises(ValueError):
            merge.merge_runs(a, b)
    for planes in ((x, y, x, x), (x, x, x, x.cpu()), (x, x[:4], x, x),
                   (x[::2], x[::2], x, x)):
        with pytest.raises(ValueError):
            merge.merge_runs3(*planes)
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_path3(*(x.cpu(),) * 4, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("chunk", [1 << 24, 1 << 14])
@pytest.mark.parametrize("use_bloom", [False, True])
def test_deferred_admission_on_card_matches_cpu(dev, chunk, use_bloom,
                                                monkeypatch):
    """The tap on the card equals the tap on the CPU, budget trips
    folding pending lanes only (the default chunk) or ladder runs."""
    from kmer_tpu_torch.kernels import bloom
    from kmer_tpu_torch.kernels.keys import from_u64
    from kmer_tpu_torch.pipeline.yak_admit import DeferredYakAdmission
    from kmer_tpu_torch.table import compactor

    monkeypatch.setattr(compactor, "_STREAM_CHUNK", chunk)
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << 62, 20_000, dtype=np.uint64)
    k = pool[rng.integers(0, 20_000, 200_000)]
    k[rng.random(k.shape[0]) < 0.1] = np.uint64((1 << 64) - 1)
    keys = torch.from_numpy(from_u64(k))
    spec = bloom.BloomSpec(10, 22, 4) if use_bloom else None
    out = []
    for device in (dev, "cpu"):
        adm = DeferredYakAdmission(spec, use_bloom, budget_bytes=1 << 20,
                                   device=device)
        for j, a in enumerate(range(0, keys.shape[0], 7_001)):
            adm.add_block(keys[a:a + 7_001].to(device), j % 3 == 2)
        pb, tot = adm.finish()
        out.append((pb.tolist(), tot, adm.fs.trips))
    assert out[0] == out[1] and out[0][2] > 0


@pytest.mark.parametrize("args", [["-k21", "-b19", "-K30000"],
                                  ["-k15", "-b20"]])
def test_yak_count_on_card_matches_cpu(dev, args, capsys, monkeypatch):
    from kmer_tpu_torch.tools import get_tool

    path = os.path.join(FIXTURES, "reads_small.fq.gz")
    out = []
    for plat in ("cuda", "cpu"):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        assert get_tool("yak-count")([*args, path]) == 0
        cap = capsys.readouterr()
        out.append((cap.out, [ln for ln in cap.err.splitlines()
                              if ln.startswith("[M")]))
    assert out[0] == out[1]


@pytest.mark.parametrize("k", [15, 31])
def test_engine_on_card_matches_cpu(dev, k, monkeypatch):
    from kmer_tpu_torch.pipeline.counter import SortCountEngine
    from kmer_tpu_torch.table import compactor

    monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 14)
    path = os.path.join(FIXTURES, "reads_small.fq.gz")
    out = []
    for device in (dev, "cpu"):
        e = SortCountEngine(k, block_bases=1 << 16, device=device,
                            budget_bytes=1 << 20)
        e.count_paths([path])
        out.append((e.hist(256, 1023).tolist(), e._n_distinct,
                    e.total_kmers))
    assert out[0] == out[1]


@pytest.mark.parametrize("budget", [2 << 30, 1 << 20])
@pytest.mark.parametrize("k", [15, 21])
def test_counts_for_on_card_matches_cpu(dev, k, budget, monkeypatch):
    """counts_for on the card (stream only, or mixed after budget trips)
    equals the CPU engine's, in query order with duplicates."""
    from kmer_tpu_torch.pipeline.counter import SortCountEngine
    from kmer_tpu_torch.table import compactor

    monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 14)
    path = os.path.join(FIXTURES, "reads_small.fq.gz")
    rng = np.random.default_rng(k)
    q = rng.integers(0, 1 << (2 * k), 5000, dtype=np.uint64)
    out = []
    for device in (dev, "cpu"):
        e = SortCountEngine(k, block_bases=1 << 16, device=device,
                            budget_bytes=budget)
        e.count_paths([path])
        if not out:  # the card's own keys, so most queries are present
            keys = e.compactor._stream_keys() if not e.compactor.runs \
                else e.compactor.runs[0][0]
            q[:2500] = (keys[:2500].cpu().numpy().view(np.uint64)
                        ^ np.uint64(1 << 63))
            q[2500:2600] = q[:100]
        hi = (q >> np.uint64(32)).astype(np.uint32)
        lo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out.append(e.counts_for(hi, lo))
    assert np.array_equal(out[0], out[1]) and (out[0][:2500] > 0).mean() > 0.5


def _counted_runs(dev, n, n_runs, seed):
    """Strictly ascending (key, int32 count) runs, about n lanes in all:
    a standing plane of n / 2 and n_runs - 1 new runs sharing the rest,
    drawn from one pool so that keys repeat across runs; counts over the
    whole uint32 range, so totals wrap."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = [n // 2] + [n // 2 // max(1, n_runs - 1)] * (n_runs - 1)
    runs = []
    for m in sizes:
        k = torch.unique(torch.randint(-n, n, (m,), generator=g, device=dev))
        c = torch.randint(-(1 << 31), 1 << 31, (k.shape[0],), generator=g,
                          device=dev, dtype=torch.int32)
        runs.append((k, c))
    return runs


@pytest.mark.parametrize("n_runs", [1, 2, 5])
def test_fold_on_card_matches_plain(dev, n_runs):
    """table/compactor.py `fold` with the merge-path kernel equals the
    fold with the plain twin on the card and on the CPU, and the
    concatenation, sort and reduce that it replaces."""
    from kmer_tpu_torch.table import compactor

    runs = _counted_runs(dev, (1 << 20) + 77, n_runs, n_runs)
    want = compactor._compact(*compactor._concat_runs(runs))
    cpu = compactor.fold([(k.cpu(), c.cpu()) for k, c in runs],
                         merge.merge_runs3_plain)
    plain = compactor.fold(list(runs), merge.merge_runs3_plain)
    got = compactor.fold(list(runs))
    for a, b in (got, want), (got, plain), (got, cpu):
        assert torch.equal(a[0].cpu(), b[0].cpu())
        assert torch.equal(a[1].cpu(), b[1].cpu())
    assert got[0].is_cuda and got[1].dtype == torch.int32


def test_fold_on_card_peaks_below_a_sort(dev):
    """At 2^26 lanes the fold, handed its runs, peaks below the
    concatenation, sort and gather of the same runs (which the engine
    held while it sorted), from the same allocation; same output."""
    from kmer_tpu_torch.table import compactor

    def peak(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev), out

    # earlier tests' cyclic garbage holding device memory would otherwise
    # be freed whenever the collector runs, between the two samples
    gc.collect()
    runs = _counted_runs(dev, 1 << 26, 4, 26)
    start = torch.cuda.memory_allocated(dev)
    sort_peak, want = peak(
        lambda: compactor._compact(*compactor._concat_runs(runs)))
    del runs
    want = tuple(x.cpu() for x in want)
    runs = _counted_runs(dev, 1 << 26, 4, 26)
    assert torch.cuda.memory_allocated(dev) == start
    fold_peak, got = peak(lambda: compactor.fold(runs))
    assert not runs
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    print(f"fold peak {fold_peak / 2**30:.3f} GiB, sort {sort_peak / 2**30:.3f}"
          f" GiB, inputs {start / 2**30:.3f} GiB")
    assert fold_peak < sort_peak


@pytest.mark.parametrize("n_hashes", [4, 40])
@pytest.mark.parametrize("fn", ["insert_sequential", "insert"])
def test_bloom_on_card_matches_cpu(dev, fn, n_hashes):
    """The bits array's test-and-set on the card equals the CPU's, lane
    for lane and byte for byte, over three 2^21-lane blocks (repeats
    within and across blocks, sentinel lanes, -H40's repeated probes)."""
    from kmer_tpu_torch.kernels import bloom
    from kmer_tpu_torch.kernels.keys import from_u64

    spec = bloom.BloomSpec(10, 24, n_hashes)
    rng = np.random.default_rng(n_hashes)
    pool = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
    out = {}
    for device in (dev, "cpu"):
        bits = bloom.make_bits(spec, device)
        r = np.random.default_rng(5)
        verdicts = []
        for _ in range(3):
            k = pool[r.integers(0, pool.shape[0], 1 << 21)]
            k[r.random(k.shape[0]) < 0.05] = np.uint64((1 << 64) - 1)
            keys = torch.from_numpy(from_u64(k)).to(device)
            _, preset = getattr(bloom, fn)(bits, keys, keys != SENT, spec)
            verdicts.append(preset.cpu())
        out[str(device)] = (torch.cat(verdicts), bits.cpu())
    (pg, bg), (pc, bc) = out.values()
    assert torch.equal(pg, pc) and torch.equal(bg, bc)
    assert pg.any() and not pg.all()


@pytest.mark.parametrize("sequential", [True, False])
def test_bloom_kernel_matches_twin_at_b37(dev, sequential):
    """csrc/bloom.cu against its plain twin on the card at -b37 (two
    16 GiB packed arrays), lane for lane and byte for byte over four
    2^21-lane blocks: repeats within and across blocks, sentinel lanes,
    a hot key in a tenth of a block's lanes; the last block through
    `admit`, the tool's gate, under which the card runs csrc/bloom.cu's
    three kernels, one entry call, and nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmer_tpu_torch.kernels import _build, bloom
    from kmer_tpu_torch.kernels.keys import from_u64

    spec = bloom.BloomSpec(10, 37, 4)
    bits, twin = bloom.make_bits(spec, dev), bloom.make_bits(spec, dev)
    assert bits.shape[0] == 1 << 34
    fn = "insert_sequential" if sequential else "insert"
    rng = np.random.default_rng(37 + sequential)
    pool = rng.integers(0, 1 << 64, 1 << 22, dtype=np.uint64)
    verdicts = set()
    for block in range(4):
        k = pool[rng.integers(0, pool.shape[0], 1 << 21)]
        k[rng.random(k.shape[0]) < 0.1] = pool[block]
        k[rng.random(k.shape[0]) < 0.05] = np.uint64((1 << 64) - 1)
        keys = torch.from_numpy(from_u64(k)).to(dev)
        _, want = getattr(bloom, fn + "_plain")(twin, keys, keys != SENT,
                                                spec)
        if block < 3:
            _, got = getattr(bloom, fn)(bits, keys, keys != SENT, spec)
            assert torch.equal(got, want)
        else:
            _build.reset_launches()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                admitted = bloom.admit(bits, keys, spec, sequential)
                torch.cuda.synchronize()
            assert torch.equal(admitted, torch.where(want, keys, SENT))
            names = {e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA}
            assert names and all(
                any(k in n for k in ("bloom_clear_kernel",
                                     "bloom_probe_kernel",
                                     "bloom_admit_kernel"))
                for n in names), names
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
                "bloom": 1}
        assert torch.equal(bits, twin)
        verdicts |= set(want.unique().tolist())
    assert verdicts == {False, True}  # batched: none preset in block 0


def test_yak_two_names_on_card(dev, tmp_path, capsys, monkeypatch):
    """Two-file yak-count given one two-member FASTQ.gz under two names
    (the benchmark's reads_twice data, 30,000 reads of 150 bases) on the
    card: at -b37 SortYakEngine holds a 16 GiB packed bloom, prints no
    clamp warning, and its stdout and `[M` lines equal the plain
    reference (h100bench/reference/yak_wide.py); at -b32 they equal the
    CPU's."""
    from h100bench.data import reads_twice
    from h100bench.reference import yak_wide
    from kmer_tpu_torch.tools import get_tool, yak_count

    cfg = {"k": 31, "genome": {"bases": 400_000, "gc": 0.41},
           "reads": {"count": 30_000, "members": 2, "length": 150,
                     "format": "fastq", "substitution_rate": 0.005,
                     "n_rate": 0.0001, "reverse_strand_share": 0.5},
           "gzip_level": 1}
    inputs = reads_twice.make(cfg, 2**33 + 25, str(tmp_path), 150, "cpu")
    paths = [f.path for f in inputs.files]
    made, real = [], yak_count.make_yak_engine
    monkeypatch.setattr(yak_count, "make_yak_engine",
                        lambda **kw: made.append(real(**kw)) or made[-1])

    def run(plat, b):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        assert get_tool("yak-count")(["-k31", "-p10", f"-b{b}", "-H4",
                                      "-K1000000", *paths]) == 0
        cap = capsys.readouterr()
        assert "[W::" not in cap.err
        return cap.out + "".join(ln + "\n" for ln in cap.err.splitlines()
                                 if ln.startswith("[M"))

    got = run("cuda", 37)
    eng = made.pop()
    assert type(eng).__name__ == "SortYakEngine" and eng.bf_shift == 37
    assert eng.device.type == "cuda"
    del eng
    assert got == yak_wide.expected(inputs.files[0].reads, 31, 10, 37, 4,
                                    1_000_000, "cpu")
    assert run("cuda", 32) == run("cpu", 32)


def test_shrink_join_on_card_matches_cpu(dev):
    from kmer_tpu_torch.kernels.keys import from_u64
    from kmer_tpu_torch.pipeline.yak import _shrink_join_core

    rng = np.random.default_rng(3)
    pool = np.unique(rng.integers(0, 1 << 64, 3 << 20, dtype=np.uint64))
    rng.shuffle(pool)
    a = np.sort(pool[:1 << 21])
    b = np.sort(pool[1 << 20:(1 << 21) + (1 << 20)])
    c2 = rng.integers(0, 1500, b.shape[0]).astype(np.uint32).view(np.int32)
    out = []
    for device in (dev, "cpu"):
        h, tot = _shrink_join_core(torch.from_numpy(from_u64(a)).to(device),
                                   torch.from_numpy(from_u64(b)).to(device),
                                   torch.from_numpy(c2).to(device), 2, 1023)
        out.append((h.cpu(), int(tot)))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1] > 0


@pytest.mark.parametrize("multiword", [False, True])
def test_myers_on_card_matches_cpu(dev, multiword):
    """The Myers scans on the card (csrc/myers.cu, one launch a call)
    equal the CPU's: 512 reads of 1..150 bases (and one of 0) against 64
    patterns of up to 32 bases, or up to 97 in 4 words, max_e 2."""
    from kmer_tpu_torch.kernels import _build, myers

    rng = np.random.default_rng(7 + multiword)
    lens_p = [33, 41, 64, 97] if multiword else [5, 21, 31, 32]
    plen = np.array([lens_p[i % 4] for i in range(64)], np.int32)
    pc = np.full((64, max(lens_p)), 255, np.uint8)
    for i, m in enumerate(plen):
        pc[i, :m] = rng.integers(0, 4, m)
    lens = rng.integers(1, 151, 512).astype(np.int32)
    lens[7] = 0
    codes = rng.integers(0, 4, (512, 150)).astype(np.uint8)
    for r in range(0, 512, 3):  # plant patterns
        i = r % 64
        m = min(int(plen[i]), int(lens[r]))
        codes[r, :m] = pc[i, :m]
    counter = "myers_multiword" if multiword else "myers"
    out = []
    for device in (dev, "cpu"):
        args = [torch.from_numpy(x).to(device) for x in (pc, plen)]
        rc = [torch.from_numpy(x).to(device) for x in (codes, lens)]
        n0 = _build.LAUNCHES[counter]
        if multiword:
            peq = myers.build_peq_multiword(*args, 4, 4)
            got = myers.myers_hw_counts_multiword(peq, args[1], *rc, 2, 4)
        else:
            peq = myers.build_peq(*args)
            got = myers.myers_hw_counts(peq, args[1], *rc, 2)
        assert _build.LAUNCHES[counter] - n0 == (device == dev)
        out.append((peq.cpu(), got.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and out[0][1].sum() > 0


def _myers_on(device, name, max_e=None):
    """One tests/torch_myers_cases.py case on device at max_e (None: the
    case's own), through the public name: the counts."""
    from kmer_tpu_torch.kernels import myers
    from torch_myers_cases import myers_case

    pc, plen, codes, lens, n_alpha, n_words, case_e = myers_case(name)
    max_e = case_e if max_e is None else max_e
    t = [torch.from_numpy(x).to(device) for x in (pc, plen, codes, lens)]
    if n_words is None:
        peq = myers.build_peq(t[0], t[1], n_alpha)
        return myers.myers_hw_counts(peq, *t[1:], max_e)
    peq = myers.build_peq_multiword(t[0], t[1], n_alpha, n_words)
    return myers.myers_hw_counts_multiword(peq, *t[1:], max_e, n_words)


@pytest.mark.parametrize("name", ["m_0_1_21_32", "n_alpha_1", "n_alpha_20",
                                  "reads_1025_1500", "zero_length_reads",
                                  "multiword_w9"])
def test_myers_kernel_matches_plain(dev, name):
    """csrc/myers.cu against the plain versions on the card, lane for
    lane, on the cases tests/test_torch_ed_vaf.py holds the plain
    versions to JAX on (m = 0, 1, 32; n_alpha 1 and 20 with codes past
    the alphabet; reads of 1,025-1,500 bases; empty reads; W = 9, the
    scratch form), at the case's max_e and at EVERY_LANE; one launch a
    call."""
    from kmer_tpu_torch.kernels import _build, myers
    from torch_myers_cases import EVERY_LANE, myers_case

    pc, plen, codes, lens, n_alpha, n_words, max_e = myers_case(name)
    t = [torch.from_numpy(x).to(dev) for x in (pc, plen, codes, lens)]
    counter = "myers" if n_words is None else "myers_multiword"
    for e in (max_e, EVERY_LANE):
        n0 = _build.LAUNCHES[counter]
        got = _myers_on(dev, name, e)
        assert _build.LAUNCHES[counter] - n0 == 1
        if n_words is None:
            peq = myers.build_peq(t[0], t[1], n_alpha)
            want = myers.myers_hw_counts_plain(peq, *t[1:], e)
        else:
            peq = myers.build_peq_multiword(t[0], t[1], n_alpha, n_words)
            want = myers.myers_hw_counts_multiword_plain(peq, *t[1:], e,
                                                         n_words)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), _myers_on("cpu", name, e))


@pytest.mark.parametrize("max_e", [1, 1 << 29])
@pytest.mark.parametrize("n_words", [None, 4])
def test_myers_kernel_at_the_tools_shape(dev, n_words, max_e):
    """ed-vaf-counter's batch: 2,048 reads of 150 bases in the 1,024-base
    bucket (255 fill) against 2,000 patterns of 21 bases (one word) or of
    45 and 97 bases (4 words), codes ACGT plus a catch-all N: the kernel
    equals the plain version on the card at the tool's max_e 1 and at
    1 << 29, past every lane's best, where every lane's count shows."""
    from kmer_tpu_torch.kernels import myers

    rng = np.random.default_rng(21 if n_words is None else 97)
    lens_p = [21] if n_words is None else [45, 97]
    plen = np.array([lens_p[i % len(lens_p)] for i in range(2000)],
                    np.int32)
    pc = rng.integers(0, 4, (2000, max(lens_p))).astype(np.uint8)
    codes = np.full((2048, 1024), 255, np.uint8)
    codes[:, :150] = rng.integers(0, 4, (2048, 150))
    codes[:, :150][rng.random((2048, 150)) < 0.001] = 4
    for r in range(0, 2048, 2):
        i = int(rng.integers(0, 2000))
        m = int(plen[i])
        at = int(rng.integers(0, 150 - m + 1))
        codes[r, at:at + m] = pc[i, :m]
    lens = np.full(2048, 150, np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (pc, plen, codes, lens)]
    if n_words is None:
        peq = myers.build_peq(t[0], t[1], 4)
        got = myers.myers_hw_counts_kernel(peq, *t[1:], max_e)
        want = myers.myers_hw_counts_plain(peq, *t[1:], max_e)
    else:
        peq = myers.build_peq_multiword(t[0], t[1], 4, n_words)
        got = myers.myers_hw_counts_multiword_kernel(peq, *t[1:], max_e,
                                                     n_words)
        want = myers.myers_hw_counts_multiword_plain(peq, *t[1:], max_e,
                                                     n_words)
    assert torch.equal(got, want) and int(got.sum()) > 1000
    if max_e > 1:
        assert bool((got >= 1).all())


def test_myers_kernel_refuses_mixed_devices(dev):
    """A CUDA tensor beside CPU ones goes to the kernel, which refuses it:
    no plain fallback from the card."""
    from kmer_tpu_torch.kernels import myers
    from torch_myers_cases import myers_case

    pc, plen, codes, lens, n_alpha, _, max_e = myers_case("n_alpha_20")
    t = [torch.from_numpy(x) for x in (pc, plen, codes, lens)]
    peq = myers.build_peq(t[0], t[1], n_alpha)
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        myers.myers_hw_counts(peq.to(dev), *t[1:], max_e)


_EDGE_LENS = [0, 1, 31, 32, 33, 64, 97]


def _edge_batch(n_words, width, seed):
    """267 patterns (lengths cycling through _EDGE_LENS, some past the 32 W
    bits of their words: the plain version never moves their score) x
    141 reads of 0-300 bases in rows of `width`, codes 0-5 against an
    alphabet of 4, a pattern planted in every third read."""
    rng = np.random.default_rng(seed)
    P, R = 267, 141
    plen = np.array([_EDGE_LENS[i % len(_EDGE_LENS)] for i in range(P)],
                    np.int32)
    pc = np.full((P, max(_EDGE_LENS)), 255, np.uint8)
    for i, m in enumerate(plen):
        pc[i, :m] = rng.integers(0, 4, m)
    lens = rng.integers(0, 301, R).astype(np.int32)
    lens[:3] = (0, 16, 300)
    codes = rng.integers(0, 6, (R, width)).astype(np.uint8)
    codes[np.arange(width)[None, :] >= lens[:, None]] = 255
    for r in range(0, R, 3):
        i = int(rng.integers(0, P))
        m = min(int(plen[i]), int(lens[r]))
        codes[r, :m] = pc[i, :m]
    return pc, plen, codes, lens


@pytest.mark.parametrize("width", [320, 301])
@pytest.mark.parametrize("n_words", [None, 2, 4, 8, 9])
def test_myers_kernels_match_plain_at_the_edges(dev, n_words, width):
    """Both forms of csrc/myers.cu (the (R, P) counts and the sums into
    an int64 total) against the plain versions on the card: P = 267, not
    a multiple of a thread's patterns nor of a block's tile; 141 reads,
    not a multiple of a block's 8 warps; m = 0, 1, 31, 32, 33, 64, 97
    with W = 1, 2, 4, 8 (registers) and 9 (the scratch plane); rows of
    320 bases (16-byte code loads) and of 301 (a byte a step); at max_e
    1 and past every lane's best.  One launch a call."""
    from kmer_tpu_torch.kernels import _build, myers

    pc, plen, codes, lens = _edge_batch(n_words, width, 3 + width)
    t = [torch.from_numpy(x).to(dev) for x in (pc, plen, codes, lens)]
    counter = "myers" if n_words is None else "myers_multiword"
    if n_words is None:
        peq = myers.build_peq(t[0], t[1], 4)
        more = ()
        kern, plain = myers.myers_hw_counts_kernel, myers.myers_hw_counts_plain
        ksum = myers.myers_hw_sums_kernel
    else:
        peq = myers.build_peq_multiword(t[0], t[1], 4, n_words)
        more = (n_words,)
        kern = myers.myers_hw_counts_multiword_kernel
        plain = myers.myers_hw_counts_multiword_plain
        ksum = myers.myers_hw_sums_multiword_kernel
    for e in (1, 1 << 29):
        want = plain(peq, *t[1:], e, *more)
        n0 = _build.LAUNCHES[counter]
        got = kern(peq, *t[1:], e, *more)
        assert _build.LAUNCHES[counter] - n0 == 1
        assert torch.equal(got, want) and int(want.sum()) > 0
        base = torch.arange(267, dtype=torch.int64, device=dev) << 33
        total = ksum(peq, *t[1:], e, *more, base.clone())
        assert _build.LAUNCHES[counter] - n0 == 2
        assert torch.equal(total - base, want.sum(0, dtype=torch.int64))


def test_myers_kernel_shapes(dev):
    """The launch plan: the register form with 4 patterns a thread for
    one word and 2 for 2-4 words, the scratch plane past 8 words (and
    past the block's shared memory: 4 words of 256 codes); a plan of
    several reads a warp at the tool's 21,000-site batch; no register
    count past 255."""
    from kmer_tpu_torch.kernels import myers

    one = myers.kernel_shape(2048, 42000, 4, 1, True, dev)
    assert one["regs"] == 1 and one["patterns"] == 4
    assert one["scratch_bytes"] == 0 and one["grid_x"] == 42000 // 128 + 1
    assert one["reads_a_warp"] > 1 and 0 < one["registers"] <= 255
    four = myers.kernel_shape(2048, 256, 4, 4, False, dev)
    assert four["regs"] == 1 and four["patterns"] == 2
    nine = myers.kernel_shape(100, 10, 4, 9, False, dev)
    assert nine["regs"] == 0 and nine["scratch_bytes"] == 2 * 9 * 100 * 10 * 4
    wide = myers.kernel_shape(100, 10, 256, 4, False, dev)
    assert wide["regs"] == 0 and wide["scratch_bytes"] > 0


def test_myers_sum_kernels_refuse_bad_totals(dev):
    """The sum entries refuse a total that is not int64 (P,) contiguous
    on the inputs' card, and inputs off the card, before any launch."""
    from kmer_tpu_torch.kernels import _build, myers
    from torch_myers_cases import myers_case

    pc, plen, codes, lens, n_alpha, _, max_e = myers_case("n_alpha_20")
    t = [torch.from_numpy(x).to(dev) for x in (pc, plen, codes, lens)]
    peq = myers.build_peq(t[0], t[1], n_alpha)
    P = plen.shape[0]
    n0 = _build.LAUNCHES["myers"]
    for total in (torch.zeros(P, dtype=torch.int32, device=dev),
                  torch.zeros(P + 1, dtype=torch.int64, device=dev),
                  torch.zeros(2 * P, dtype=torch.int64, device=dev)[::2],
                  torch.zeros(P, dtype=torch.int64)):
        with pytest.raises(ValueError, match="int64 total"):
            myers.myers_hw_sums(peq, *t[1:], max_e, total)
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        myers.myers_hw_sums(peq, t[1], t[2].cpu(), t[3], max_e,
                            torch.zeros(P, dtype=torch.int64, device=dev))
    assert _build.LAUNCHES["myers"] == n0


def test_ed_vaf_one_sum_launch_a_batch(tmp_path, dev, monkeypatch):
    """ed-vaf-counter on the card over many small batches (_BATCH_BYTES
    24 KiB) with patterns of 21 and 41 bases: one `myers` launch and one
    `myers_multiword` launch a batch, both through the sum entries (the
    (R, P) entries are never called), no other kernel, and the VAF file
    equals the CPU's."""
    from kmer_tpu_torch.kernels import _build, myers
    from kmer_tpu_torch.tools import ed_vaf_counter as tool, get_tool

    rng = np.random.default_rng(41)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    rows = []
    for i, k in enumerate([21, 41, 21, 41]):
        pos = 2000 + 4000 * i
        ref = g[pos - k // 2:pos + k // 2 + 1]
        alt = ref[:k // 2] + ("A" if g[pos] != "A" else "C") + ref[k // 2 + 1:]
        rows.append(f"chr1\t{pos}\t{pos + 1}\trs{i}\t{g[pos]}\t"
                    f"{alt[k // 2]}\t{ref}\t{alt}")
    pat = str(tmp_path / "p.pat")
    with open(pat, "w") as f:
        f.write("\n".join(rows) + "\n")
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for r in range(300):
            st = int(rng.integers(0, len(g) - 150))
            f.write(f"@r{r}\n{g[st:st + 150]}\n+\n{'I' * 150}\n")
    monkeypatch.setattr(tool, "_BATCH_BYTES", 24 << 10)
    calls = []
    for name in ("myers_hw_counts_kernel",
                 "myers_hw_counts_multiword_kernel"):
        monkeypatch.setattr(myers, name,
                            lambda *a, n=name: calls.append(n))
    files = []
    for plat in ("cuda", "cpu"):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        batches = []
        real = tool._Staging.upload
        monkeypatch.setattr(tool._Staging, "upload",
                            lambda self, *a: batches.append(a[2]) or
                            real(self, *a))
        _build.reset_launches()
        vaf = str(tmp_path / f"{plat}.vaf")
        assert get_tool("ed-vaf-counter")(["-e1", "-p", pat, "-o", vaf,
                                           fq]) == 0
        monkeypatch.setattr(tool._Staging, "upload", real)
        want = ({"myers": len(batches), "myers_multiword": len(batches)}
                if plat == "cuda" else {})
        assert len(batches) == 13
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
        with open(vaf, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1] and not calls
    rows = files[0].decode().splitlines()[2:]
    assert sum(int(ln.split("\t")[7]) for ln in rows) > 0


@pytest.mark.parametrize("args", [["-k31", "-b19", "-K65536"],
                                  ["-k15", "-b19"], ["-b0"]])
def test_yak_two_files_on_card_matches_cpu(dev, args, capsys, monkeypatch):
    from kmer_tpu_torch.tools import get_tool

    paths = [os.path.join(FIXTURES, f) for f in ("sampleA1.fq.gz",
                                                 "sampleB.fq.gz")]
    out = []
    for plat in ("cuda", "cpu"):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        assert get_tool("yak-count")([*args, *paths]) == 0
        cap = capsys.readouterr()
        out.append((cap.out, [ln for ln in cap.err.splitlines()
                              if ln.startswith("[M")]))
    assert out[0] == out[1]


def test_ed_vaf_on_card_matches_cpu(tmp_path, dev, monkeypatch):
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.tools import get_tool

    fq = os.path.join(FIXTURES, "sampleA1.fq.gz")
    pat = str(tmp_path / "p.pat")
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    assert get_tool("snp-pattern-gen")(
        ["-k21", "-b", os.path.join(FIXTURES, "snps_small.bed"), "-f",
         os.path.join(FIXTURES, "genome_small.fa.gz"), "-o", pat]) == 0
    files = []
    for plat in ("cuda", "cpu"):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        vaf = str(tmp_path / f"{plat}.vaf")
        n0 = _build.LAUNCHES["myers"]
        assert get_tool("ed-vaf-counter")(["-e1", "-p", pat, "-o", vaf,
                                           fq]) == 0
        # one launch a batch of reads on the card, none on the CPU
        assert (_build.LAUNCHES["myers"] > n0) == (plat == "cuda")
        with open(vaf, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]


@pytest.mark.parametrize("n", [1 << 16, 1 << 20, 10_312_504])
def test_unpack_on_card_matches_cpu(dev, n):
    """The packed ingest's unpack (plain torch on uint8) on the card, with
    a mask and structural, equals the CPU's."""
    from kmer_tpu_torch.pipeline import counter

    rng = np.random.default_rng(n)
    packed = torch.from_numpy(rng.integers(0, 256, n // 4, dtype=np.uint8))
    mask = torch.from_numpy(rng.integers(0, 256, n // 8, dtype=np.uint8))
    got = counter._unpack_ascii(packed.to(dev), mask.to(dev))
    assert torch.equal(got.cpu(), counter._unpack_ascii(packed, mask))
    for rb in (151, 32):
        n_used = n - n // 3
        got = counter._structural_ascii(packed.to(dev), n_used, rb)
        assert torch.equal(got.cpu(),
                           counter._structural_ascii(packed, n_used, rb))


@pytest.mark.parametrize("k", [15, 31])
def test_packed_engine_on_card_matches_cpu(dev, k, monkeypatch):
    """kc-c4's engine under KMER_TPU_PACKED=1 on the card equals the CPU's
    and the card's ASCII path."""
    from kmer_tpu_torch.pipeline.counter import SortCountEngine

    path = os.path.join(FIXTURES, "reads_small.fq.gz")
    out = []
    for device, packed in ((dev, "1"), ("cpu", "1"), (dev, "0")):
        monkeypatch.setenv("KMER_TPU_PACKED", packed)
        e = SortCountEngine(k, block_bases=1 << 16, device=device)
        e.count_paths([path])
        out.append((e.hist(256, 1023).tolist(), e._n_distinct,
                    e.total_kmers))
    assert out[0] == out[1] == out[2]


@pytest.mark.parametrize("k", [15, 31])
def test_mesh_on_card_matches_cpu_mesh(dev, k, capsys, monkeypatch):
    """A mesh of four shards dealt round-robin over the visible cards
    (on one card, four logical shards of it; on four, one a card, each
    shard's kernels launched on its own card) counts what four CPU
    shards count (kc-c4's engine, budget trips included), and two-file
    yak-count on it prints what the CPU mesh prints, `[M` lines too."""
    from kmer_tpu_torch.dist import sharded
    from kmer_tpu_torch.pipeline.counter import MeshSortCountEngine
    from kmer_tpu_torch.tools import get_tool

    paths = [os.path.join(FIXTURES, f) for f in ("sampleA1.fq.gz",
                                                 "sampleB.fq.gz")]
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", j % n_cards) for j in range(4)]
    cpus = [torch.device("cpu")] * 4
    out = []
    for devices in (cards, cpus):
        e = MeshSortCountEngine(k, block_bases=1 << 18, devices=devices,
                                budget_bytes=1 << 18)
        e.count_paths(paths)
        out.append((e.hist(256, 1023).tolist(), e._n_distinct,
                    e.total_kmers))
    assert out[0] == out[1]
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    out = []
    for plat, devices in (("cuda", cards), ("cpu", cpus)):
        monkeypatch.setenv("KMER_TPU_PLATFORM", plat)
        monkeypatch.setattr(sharded, "default_devices",
                            lambda d=devices: list(d))
        assert get_tool("yak-count")([f"-k{k}", "-b19", "-K65536",
                                      *paths]) == 0
        cap = capsys.readouterr()
        out.append((cap.out, [ln for ln in cap.err.splitlines()
                              if ln.startswith("[M")]))
    assert out[0] == out[1] and len(out[0][1]) > 2


def test_kernels_launch_on_the_tensors_card(dev):
    """Every kernel wrapper, given tensors on the last visible card while
    the first card is current, launches on the tensors' card and agrees
    with its plain version (a mesh puts shard j on cuda:j; on one card
    both are cuda:0).  The (key, index) merge needs more than 48 KiB of
    shared memory, an attribute set for the current card only."""
    card = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(0):
        x = torch.from_numpy(np.random.default_rng(5).choice(
            np.frombuffer(b"ACGTN", np.uint8), size=(1 << 16) + 7)).to(card)
        keys, nv = extract.extract_keys(x, 31)
        want, nw = extract.extract_keys_plain(x, 31)
        assert torch.equal(keys, want) and int(nv) == int(nw)
        keys, _ = _sorted_keys(card, (1 << 16) + 3, 1)
        hist, nd = seghist.segment_hist_sorted(keys, None, _CFGS[0])
        want, wnd = seghist.segment_hist_sorted_plain(keys, None, _CFGS[0])
        assert torch.equal(hist, want) and int(nd) == int(wnd)
        for a, b in (_runs(card, 4097, 12345, 2), _runs1(card, 4097, 12345,
                                                          3)):
            assert torch.equal(merge.merge_runs(a, b),
                               torch.sort(torch.cat([a, b])).values)
        _check_merge3(_runs3(card, 4097, 12345, 4))
        t = _table_case(card, 12, 0.3, "fresh", 9)
        _check_resolve(t, True)
        _check_resolve(_table_case(card, 14, 0.6, "dup", 10), False)
        from kmer_tpu_torch.kernels import table as kt
        tail = kt.kernel_shape(card)["tail_lanes"]
        keys, valid = _lanes(card, 4 * tail, [(0xA11, tail + 1)], 3)
        _check_resolve((_chained(card, 1 << 16, [(0xA11, 40)]), keys,
                        valid), True)
        for name in ("n_alpha_20", "multiword_w9"):
            assert torch.equal(_myers_on(card, name).cpu(),
                               _myers_on("cpu", name))
        assert torch.cuda.current_device() == 0


# -- the count table's slot resolution (csrc/table.cu) -------------------

def _table_case(dev, log2m, load, kind, seed):
    """(table, keys, valid) on dev: a table near `load` (its keys inserted
    with the plain resolve, a tenth of them then rolled back to DELETED
    by insert_gated) sized so that 2^log2m lanes fit under GROW_LOAD; the
    batch's keys: `fresh` (a pool of m / 4 distinct keys, half of them
    in the table), `dup` (8 keys), or `one` (k = 32: one key)."""
    from kmer_tpu_torch.table import count_table as ct

    g = torch.Generator(device=dev).manual_seed(seed)
    m = 1 << log2m
    n0 = int(load * m)
    cap = 1 << max(4, (int((n0 + m) / 0.65)).bit_length())
    table = ct.make(cap, dev)
    old = torch.randint(-(1 << 62), 1 << 62, (max(n0, 1),), generator=g,
                        device=dev)
    if n0:
        ones = torch.ones(n0, dtype=torch.bool, device=dev)
        table, _ = ct.insert(table, old, ones, 1023, plain_kernels=True)
        ghosts = torch.randint(-(1 << 62), 1 << 62, (n0 // 10 + 1,),
                               generator=g, device=dev)
        table, _, nd = ct.insert_gated(
            table, ghosts, torch.ones_like(ghosts, dtype=torch.bool),
            torch.zeros_like(ghosts, dtype=torch.bool), 1023,
            plain_kernels=True)
        assert int(nd) == ghosts.shape[0]
    n_pool = {"fresh": max(m // 4, 2), "dup": 8, "one": 1}[kind]
    pool = torch.randint(-(1 << 62), 1 << 62, (n_pool,), generator=g,
                         device=dev)
    pool[: n_pool // 2] = old[torch.randint(0, old.shape[0], (n_pool // 2,),
                                            generator=g, device=dev)]
    keys = pool[torch.randint(0, n_pool, (m,), generator=g, device=dev)]
    valid = torch.rand(m, generator=g, device=dev) > 0.1
    keys[~valid] = SENT
    return table, keys, valid


def _check_resolve(case, create_new):
    from kmer_tpu_torch.kernels import table as kt

    table, keys, valid = case
    st, tk = table.state.clone(), table.key.clone()
    got = kt.resolve_slots(table.state, table.key, keys, valid, create_new)
    want = kt.resolve_slots_plain(st, tk, keys, valid, create_new)
    torch.cuda.synchronize()
    for a, b in ((table.state, st), (table.key, tk), (got.slot, want.slot),
                 (got.found, want.found), (got.created, want.created)):
        assert torch.equal(a, b)
    assert (got.rounds, got.probes) == (want.rounds, want.probes)
    return got


@pytest.mark.parametrize("create_new", [True, False])
@pytest.mark.parametrize("kind", ["fresh", "dup", "one"])
@pytest.mark.parametrize("load", [0.0, 0.6])
@pytest.mark.parametrize("log2m", [20, 22, 24])
def test_resolve_kernel_matches_plain(dev, log2m, load, kind, create_new):
    """csrc/table.cu against the plain round loop on the same table and
    batch: planes, slot, found, created, rounds and probes all equal, in
    one launch; a fresh table and one near GROW_LOAD with tombstones,
    lookups (create_new off) included."""
    from kmer_tpu_torch.kernels import _build

    case = _table_case(dev, log2m, load, kind, log2m * 7 + int(10 * load))
    n0 = _build.LAUNCHES["resolve"]
    got = _check_resolve(case, create_new)
    assert _build.LAUNCHES["resolve"] - n0 == 1 and got.rounds > 0


def _chained(dev, cap, chains):
    """A table of cap slots where each (key, length) of `chains` finds
    `length` slots FULL with other keys from its home slot on, then its
    first EMPTY one (chains that meet run on together)."""
    from kmer_tpu_torch.kernels.hash64 import slot_mix32
    from kmer_tpu_torch.table import count_table as ct

    table = ct.make(cap, dev)
    filler = 1 << 40
    for key, length in chains:
        home = int(slot_mix32(torch.tensor([key]))[0]) & (cap - 1)
        run = (home + torch.arange(length, device=dev)) & (cap - 1)
        table.state[run] = ct.FULL
        table.key[run] = filler + torch.arange(length, device=dev)
        filler += length
    return table


def _lanes(dev, m, groups, seed):
    """m lanes, invalid but for each (key, count) of `groups`: count lanes
    of that key at random places."""
    rng = np.random.default_rng(seed)
    keys = np.full(m, int(SENT), np.int64)
    at = rng.permutation(m)
    i = 0
    for key, count in groups:
        keys[at[i:i + count]] = key
        i += count
    keys = torch.from_numpy(keys).to(dev)
    return keys, keys != SENT


@pytest.mark.parametrize("create_new", [True, False])
def test_resolve_kernel_no_valid_lane(dev, create_new):
    """No valid lane: no round, no probe, the planes untouched, every
    lane absent."""
    table = _chained(dev, 1 << 10, [(7, 20)])
    keys = torch.full((5000,), SENT, dtype=torch.int64, device=dev)
    st, tk = table.state.clone(), table.key.clone()
    got = _check_resolve((table, keys, keys != SENT), create_new)
    assert (got.rounds, got.probes) == (0, 0)
    assert torch.equal(table.state, st) and torch.equal(table.key, tk)
    assert bool((got.slot == 1 << 10).all()) and not bool(got.found.any())
    assert not bool(got.created.any())


@pytest.mark.parametrize("create_new", [True, False])
def test_resolve_kernel_long_chain_into_the_tail(dev, create_new):
    """A batch of 2^20 lanes over a table near GROW_LOAD, with a few lanes
    of one key whose chain holds 300 FULL slots: the grid's rounds, then
    more than 256 rounds of the one-block tail."""
    table, keys, valid = _table_case(dev, 20, 0.6, "fresh", 77)
    key = 0x5EED
    chained = _chained(dev, table.capacity, [(key, 300)])
    run = chained.state == 1
    table.state[run], table.key[run] = 1, chained.key[run]
    keys[torch.tensor([3, 4, 100_000, (1 << 20) - 1], device=dev)] = key
    valid = keys != SENT
    got = _check_resolve((table, keys, valid), create_new)
    assert got.rounds > 300


@pytest.mark.parametrize("create_new", [True, False])
@pytest.mark.parametrize("over", [-1, 0, 1])
def test_resolve_kernel_straddles_the_tail(dev, over, create_new):
    """Round 1's survivors one under, at and one over the one-block tail's
    lanes: a group of duplicates walks 3 slots (then claims, or is
    absent), 5 lanes of another key walk 20."""
    from kmer_tpu_torch.kernels import table as kt

    tail = kt.kernel_shape(dev)["tail_lanes"]
    a, b = 0xA11, 0xB22
    table = _chained(dev, 1 << 16, [(a, 3), (b, 20)])
    keys, valid = _lanes(dev, 4 * tail, [(a, tail + over - 5), (b, 5)],
                         over + 2)
    got = _check_resolve((table, keys, valid), create_new)
    assert got.rounds == 20 + 1 + create_new
    assert got.probes > 3 * (tail + over)


@pytest.mark.parametrize("chain", [255, 300])
def test_resolve_kernel_tag_wraps(dev, chain):
    """2^24 lanes, six of them valid: four of one key that claim its
    slot after `chain` rounds, where round * m has reached 2^32 (at 255
    the last lane's tag wraps to 0 and loses), two of a fresh key."""
    m = 1 << 24
    key = 0x7A6
    table = _chained(dev, 1 << 12, [(key, chain)])
    keys = torch.full((m,), SENT, dtype=torch.int64, device=dev)
    keys[torch.tensor([0, 7, m // 2, m - 1], device=dev)] = key
    keys[torch.tensor([11, m - 2], device=dev)] = 0x123
    got = _check_resolve((table, keys, keys != SENT), True)
    assert got.rounds == chain + 2


def test_resolve_kernel_raises_at_the_round_limit(dev):
    """20 distinct keys into 8 slots: the kernel stops at the round limit
    and the wrapper raises, as the plain version does."""
    from kmer_tpu_torch.kernels import table as kt
    from kmer_tpu_torch.table import count_table as ct

    keys = torch.arange(1, 21, dtype=torch.int64, device=dev)
    valid = torch.ones(20, dtype=torch.bool, device=dev)
    for fn in (kt.resolve_slots_kernel, kt.resolve_slots_plain):
        t = ct.make(8, dev)
        with pytest.raises(RuntimeError, match="more distinct keys"):
            fn(t.state, t.key, keys, valid, True)
    with pytest.raises(RuntimeError, match="more distinct keys"):
        ct.insert(ct.make(8, dev), keys, valid, None)


def test_resolve_kernel_reads_the_host_once(dev):
    """One call synchronizes the host once (the read of rounds, probes
    and the limit's flag) and launches once."""
    import warnings

    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.kernels import table as kt

    table, keys, valid = _table_case(dev, 16, 0.6, "fresh", 5)
    torch.cuda.synchronize()
    n0 = _build.LAUNCHES["resolve"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = kt.resolve_slots(table.state, table.key, keys, valid, True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1 and _build.LAUNCHES["resolve"] - n0 == 1
    assert got.rounds > 1


@pytest.mark.parametrize("mesh", [False, True])
def test_table_yak_engines_on_card_match_plain_and_cpu(dev, mesh):
    """YakEngine (and MeshYakEngine on four shards of the card) through
    the two-file flow: the kernel run's planes after pass 1, hist and
    `[M` totals equal the card run with plain versions and the CPU run."""
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.pipeline import yak
    from kmer_tpu_torch.table import count_table as ct

    paths = [os.path.join(FIXTURES, f) for f in ("sampleA1.fq.gz",
                                                 "sampleB.fq.gz")]
    kw = dict(k=31, pre=10, bf_shift=19, bf_n_hash=4, chunk_size=1 << 16)
    out = []
    for where, plain in ((dev, False), (dev, True), ("cpu", False)):
        logs = []
        if mesh:
            e = yak.MeshYakEngine(devices=[where] * 4, plain_kernels=plain,
                                  log=lambda n, t: logs.append((n, t)), **kw)
        else:
            e = yak.YakEngine(device=where, plain_kernels=plain,
                              log=lambda n, t: logs.append((n, t)), **kw)
        n0 = _build.LAUNCHES["resolve"]
        e.count([paths[0]], create_new=True)
        tables = e.tables if mesh else [e.table]
        planes = [[x.tolist() for x in ct.to_jax_planes(t)] for t in tables]
        if where != "cpu":
            assert (_build.LAUNCHES["resolve"] > n0) != plain
        e.destroy_bloom()
        e.clear()
        e.count([paths[1]], create_new=False)
        e.shrink(2, 1023)
        out.append((planes, logs, e.tot, e.hist().tolist()))
    assert out[0] == out[1] == out[2]
