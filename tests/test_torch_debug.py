"""KMER_TPU_DEBUG in the port (kmer_tpu_torch/table/compactor.py) against
the JAX package's, on the CPU.  Every comparison is exact (integer
outputs, tolerance 0).

* The general derivations against the JAX functions they stand for:
  `_hist_general` against `_hist_impl`, `_counts_for_sortjoin` against
  `_counts_for_sortjoin_impl`, `_counts_for_join` against
  `_counts_for_impl` (and the binary-search join against
  `_counts_for_bs_impl`), on numpy-seeded planes.
* The tools under the switch: each writes what it writes with the switch
  unset (when the general functions may not run at all) and what the JAX
  tool writes under the switch, and the cross-check counter moves.
* Weighted key totals at 2^31, 0x90000000, 2^32 - 1, 2^32 and 2^32 + 3:
  the port's `KmerCompactor.hist` == the JAX package's, one-plane and
  two-plane, with the switch set and unset.
* Fault injection: a seghist twin that moves one count between bins, a
  merge twin that swaps two adjacent lanes, and a binary-search join off
  by one each raise AssertionError naming KMER_TPU_DEBUG under the
  switch, and pass unnoticed without it.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.table import compactor as JC
from kmer_tpu_torch.kernels import keys, merge, seghist
from kmer_tpu_torch.table import compactor as TC

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
BED = os.path.join(FIXTURES, "snps_small.bed")
SAMPLE = os.path.join(FIXTURES, "sampleA1.fq.gz")
ALL_ONES = (1 << 64) - 1
U32 = np.uint64(0xFFFFFFFF)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(k):
    k = np.asarray(k, np.uint64)
    return (k >> np.uint64(32)).astype(np.uint32), (k & U32).astype(np.uint32)


def _plane(rng, key_bits, weighted, n=4000):
    """n lanes over 300 keys below 2^key_bits: one key 300 times and one
    1,300 times (past bins 255 and 1023), 10% sentinel lanes; weighted
    lanes carry uint32 counts, small ones (for min_keep) and ones near
    2^32 (totals that wrap 2^32, and totals in [2^31, 2^32))."""
    pool = np.unique(rng.integers(0, 1 << key_bits, 300, dtype=np.uint64))
    k = rng.choice(pool, n)
    k[:300], k[300:1600] = pool[0], pool[1]
    k[rng.random(n) < 0.1] = ALL_ONES
    rng.shuffle(k)
    c = None
    if weighted:
        c = rng.integers(0, 3, n, dtype=np.uint64)
        big = rng.random(n) < 0.2
        c[big] = rng.integers(0xC0000000, 1 << 32, int(big.sum()),
                              dtype=np.uint64)
        c = c.astype(np.uint32)
    return pool, k, c


def _port_plane(k, c, one_plane, pre_sorted):
    """The port's plane of the same lanes: biased int64 keys (sorted and
    narrowed to the int32 one-plane layout when pre_sorted one-plane),
    int32 counts holding the uint32 ones."""
    t = keys.from_hi_lo(*_split(k))
    if pre_sorted:
        t = torch.sort(t).values
        if one_plane:
            t = keys.narrow(t)
    return t, None if c is None else torch.from_numpy(c.view(np.int32))


def _jax_planes(k, one_plane, pre_sorted):
    hi, lo = _split(np.sort(k) if pre_sorted else k)
    return jnp.asarray(hi), jnp.asarray(lo)


# (weighted, one_plane, pre_sorted, n_bins, max_count, min_keep): kc's
# bins, yak-count's, and both with min_keep 2
HIST_CASES = [
    (False, False, False, 256, None, 1),
    (False, False, True, 256, 255, 2),
    (False, True, True, 256, None, 1),
    (False, True, False, 1024, 1023, 2),
    (True, False, False, 256, None, 1),
    (True, False, False, 1024, 1023, 2),
    (True, True, False, 256, 255, 2),
    (True, True, False, 1024, None, 1),
]


@pytest.mark.parametrize("case", HIST_CASES, ids=str)
def test_hist_general_matches_jax(case):
    """`_hist_general` equals the JAX package's general histogram
    (`_hist_impl`, the KMER_TPU_DEBUG oracle) bin for bin, bin 0 and
    n_distinct included."""
    weighted, one_plane, pre_sorted, n_bins, max_count, min_keep = case
    rng = np.random.default_rng(HIST_CASES.index(case))
    _, k, c = _plane(rng, 30 if one_plane else 62, weighted)
    hi, lo = _jax_planes(k, one_plane, pre_sorted)
    h, nd = JC._hist_impl(hi, lo, jnp.asarray(c) if weighted else hi,
                          n_bins, max_count, min_keep, weighted, one_plane,
                          pre_sorted)
    got, got_nd = TC._hist_general(*_port_plane(k, c, one_plane, pre_sorted),
                                   n_bins, max_count, min_keep)
    assert got.dtype == torch.int64 and got.shape == (n_bins,)
    assert np.array_equal(got.numpy(), np.asarray(h)) and got_nd == int(nd)
    assert got[n_bins - 1] > 0 and got_nd > 0


# (weighted, one_plane, pre_sorted)
JOIN_CASES = [(False, False, False), (False, True, True), (True, False, False),
              (True, True, False)]


@pytest.mark.parametrize("case", JOIN_CASES, ids=str)
def test_sort_joins_match_jax(case):
    """`_counts_for_sortjoin` / `_counts_for_join` against the JAX sort-
    joins and the binary-search join on present, absent and duplicated
    queries (with two planes the all-ones key too), in query order.  On
    the all-ones key the JAX sort-join counts the plane's sentinel lanes,
    where both binary searches answer 0; the port's sort-join holds no
    sentinel lane as data and answers 0 there as well."""
    weighted, one_plane, pre_sorted = case
    rng = np.random.default_rng(10 + JOIN_CASES.index(case))
    key_bits = 30 if one_plane else 64
    pool, k, c = _plane(rng, key_bits, weighted)
    q = np.concatenate([rng.choice(pool, 200),
                        rng.integers(0, (1 << key_bits) - 2, 50,
                                     dtype=np.uint64)])
    if not one_plane:
        q = np.concatenate([q, [ALL_ONES]]).astype(np.uint64)
    q = np.concatenate([q, q[:30]])
    hi, lo = _jax_planes(k, one_plane, pre_sorted)
    phi, plo, nq, inverse = JC.prep_queries(*_split(q), one_plane)
    phi, plo = jnp.asarray(phi), jnp.asarray(plo)
    if weighted:
        cj = jnp.asarray(c)
        want = JC._counts_for_impl(hi, lo, cj, phi, plo, True, one_plane)
    else:
        cj = hi
        dhi = (jnp.where(lo == JC.SENT, JC.SENT, jnp.uint32(0))
               if pre_sorted and one_plane else hi)
        want = JC._counts_for_sortjoin_impl(dhi, lo, phi, plo, one_plane)
    bs = JC._counts_for_bs_impl(hi, lo, cj, phi, plo, weighted, one_plane,
                                pre_sorted)
    want = (np.asarray(want)[:nq].astype(np.int64) & 0xFFFFFFFF)[inverse]
    bs = np.asarray(bs)[:nq].astype(np.int64)[inverse]
    plane = _port_plane(k, c, one_plane, pre_sorted)
    pk = keys.widen(plane[0]) if plane[0].dtype == torch.int32 else plane[0]
    tq = keys.from_hi_lo(*_split(q))
    got = (TC._counts_for_join(pk, plane[1], tq) if weighted
           else TC._counts_for_sortjoin(pk, tq)).numpy()
    ones = q == np.uint64(ALL_ONES)
    assert np.array_equal(got[~ones], want[~ones])
    assert np.array_equal(got, bs) and not got[ones].any()
    assert got[:200].all() if not weighted else got[:200].any()
    if ones.any():
        assert want[ones].all()  # the JAX sort-join's sentinel count
    # the port's own binary-search join on its sorted plane
    sk, sc = TC._sort(pk, plane[1])
    assert np.array_equal(TC._counts_for_bs(sk, sc, tq).numpy(), got)


@pytest.mark.parametrize("bins_cfg", [(256, None, 1), (256, 255, 2),
                                      (1024, 1023, 2)])
@pytest.mark.parametrize("key_bits", [64, 30])
@pytest.mark.parametrize("total", [1 << 31, 0x90000000, (1 << 32) - 1,
                                   1 << 32, (1 << 32) + 3])
def test_segment_total_past_int32_matches_jax(total, key_bits, bins_cfg,
                                              monkeypatch):
    """Two keys whose weighted totals sum to `total` over two counted
    runs, one mid-plane and one the plane's last (the segment
    histogram's open final run), beside keys of small totals, in a
    two-plane and a one-plane compactor: the port's `hist` == the JAX
    package's `KmerCompactor.hist` on the CPU (its XLA form reads a
    total as uint32: [2^31, 2^32) in the last bin, 2^32 wraps to 0 and
    is dropped, 2^32 + 3 lands in bin 3), bin for bin and in
    n_distinct, and under KMER_TPU_DEBUG=1 the check passes."""
    from kmer_tpu.kernels import u64 as U

    top = (1 << key_bits) - 2
    k = np.asarray([3, 7, 9, 12, top // 2, top], np.uint64)
    rng = np.random.default_rng(total % 1000 + key_bits)
    s = rng.integers(1, 9, size=5).tolist()  # small counts, keys 0, 2-4
    c = int(rng.integers(1 << 31, 1 << 32))  # the first part of `total`
    rest = (total - c) % (1 << 32)
    runs = [(k[[1, 0, 5, 2]], [c, s[0], c, s[1]]),
            (k[[5, 3, 1, 4, 3]], [rest, s[2], rest, s[3], s[4]])]
    t = TC.KmerCompactor("cpu", key_bits=key_bits)
    j = JC.KmerCompactor(key_bits=key_bits)
    assert t.one_plane == j.one_plane == (key_bits == 30)
    for rk, rc in runs:
        rc = np.asarray(rc, np.uint32)
        t.add_counted(keys.from_hi_lo(*_split(rk)),
                      torch.from_numpy(rc.view(np.int32)))
        j.add_counted(U.U64(*(jnp.asarray(p) for p in _split(rk))),
                      jnp.asarray(rc))
    want, want_nd = j.hist(*bins_cfg)
    kept = [x >= bins_cfg[2] for x in (s[0], s[1], s[2] + s[4], s[3])]
    u32 = total % (1 << 32)
    assert want_nd == sum(kept) + 2 * (u32 >= bins_cfg[2])
    assert want[-1] >= 2 * (u32 >= 1 << 31)
    got, got_nd = t.hist(*bins_cfg)
    assert np.array_equal(got, want) and got_nd == want_nd
    monkeypatch.setenv("KMER_TPU_DEBUG", "1")
    before = TC.DEBUG_CHECKS["hist"]
    got, got_nd = t.hist(*bins_cfg)
    assert np.array_equal(got, want) and got_nd == want_nd
    assert TC.DEBUG_CHECKS["hist"] == before + 1


# -- the tools under the switch ----------------------------------------

def _tool(pkg, name, args):
    """(exit code, stdout, the `[M` stderr lines) of one tool run."""
    import importlib

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = importlib.import_module(f"{pkg}.tools").get_tool(name)(args)
    return rc, out.getvalue(), [ln for ln in err.getvalue().splitlines()
                                if ln.startswith("[M")]


def _no_general(monkeypatch):
    """Make every general-path function fail if it is called."""
    def refuse(*a, **kw):
        raise RuntimeError("a KMER_TPU_DEBUG function ran without the switch")

    for name in ("_hist_general", "_counts_for_sortjoin", "_counts_for_join"):
        monkeypatch.setattr(TC, name, refuse)


_jax_want = {}


def _jax_debug(name, args, monkeypatch):
    """The JAX tool's run under KMER_TPU_DEBUG=1, once per argument list."""
    key = (name, tuple(args))
    if key not in _jax_want:
        with monkeypatch.context() as m:
            m.setenv("KMER_TPU_DEBUG", "1")
            _jax_want[key] = _tool("kmer_tpu", name, args)
    return _jax_want[key]


def _port_both(name, args, monkeypatch, method):
    """The port's run with the switch unset (no general function may run)
    and under it; returns both and the checks the second one made."""
    with monkeypatch.context() as m:
        _no_general(m)
        before = dict(TC.DEBUG_CHECKS)
        plain = _tool("kmer_tpu_torch", name, args)
        assert TC.DEBUG_CHECKS == before
    with monkeypatch.context() as m:
        m.setenv("KMER_TPU_DEBUG", "1")
        checked = _tool("kmer_tpu_torch", name, args)
    made = TC.DEBUG_CHECKS[method] - before[method]
    return plain, checked, made


# trip: 2^16-base blocks and a budget that trips once
# mid-file and leaves stream runs beside the counted one (mixed state)
TRIP_BUDGET = {31: 2_000_000, 15: 1_000_000}


@pytest.mark.parametrize("mode", ["default_chunk", "small_chunk", "trip",
                                  "mesh"])
@pytest.mark.parametrize("k", [31, 15])
def test_kc_c4_under_debug(k, mode, monkeypatch):
    """kc-c4 on the reads fixture: the same stdout with the switch unset,
    under it, and from the JAX tool under it; the port's hist was
    checked (once a shard on a 4-shard CPU mesh).  default_chunk leaves
    the whole file pending in the ladder until hist; the other modes take
    2^15-lane chunks, so the ladder merges."""
    from kmer_tpu_torch.dist import sharded
    from kmer_tpu_torch.tools import kc

    args = [f"-k{k}", READS]
    want = _jax_debug("kc-c4", args, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    if mode != "default_chunk":
        monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 15)
    made = []
    real = kc.make_count_engine

    def engine(**kw):
        if mode == "trip":
            kw.update(block_bases=1 << 16, budget_bytes=TRIP_BUDGET[k])
        made.append(real(**kw))
        return made[-1]

    monkeypatch.setattr(kc, "make_count_engine", engine)
    if mode == "mesh":
        monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
        monkeypatch.setattr(sharded, "default_devices",
                            lambda: [torch.device("cpu")] * 4)
    plain, checked, n_checks = _port_both("kc-c4", args, monkeypatch, "hist")
    assert want[0] == 0 and len(want[1].splitlines()) == 255
    assert plain == checked == want
    assert n_checks == (4 if mode == "mesh" else 1)
    if mode == "trip":
        # the stream folded into the trip's standing plane at hist
        runs = made[-1].compactor.runs
        assert [c is None for _, c in runs] == [False]


def test_yak_count_under_debug(monkeypatch):
    """Single-file yak-count -k21 -b14: stdout and the `[M` lines."""
    args = ["-k21", "-b14", READS]
    want = _jax_debug("yak-count", args, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    plain, checked, n_checks = _port_both("yak-count", args, monkeypatch,
                                          "hist")
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    assert plain == checked == want and n_checks == 1


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def patterns(tmp_path, monkeypatch):
    """snp-pattern-gen on the fixtures, its file from the JAX tool and
    from the port, both under the switch and the port's also without;
    the port's counts_for was checked."""
    outs = []
    for pkg in ("kmer_tpu", "kmer_tpu_torch", "kmer_tpu_torch"):
        pat = str(tmp_path / f"{pkg}{len(outs)}.pat")
        args = ["-k21", "-b", BED, "-f", GENOME, "-o", pat]
        with monkeypatch.context() as m:
            m.setenv("KMER_TPU_PLATFORM", "cpu")
            if len(outs) < 2:
                m.setenv("KMER_TPU_DEBUG", "1")
            else:
                _no_general(m)
            before = TC.DEBUG_CHECKS["counts_for"]
            assert _tool(pkg, "snp-pattern-gen", args)[0] == 0
            outs.append((_read(pat), TC.DEBUG_CHECKS["counts_for"] - before))
    assert outs[0][0] == outs[1][0] == outs[2][0] and outs[0][0]
    assert outs[1][1] == 1 and outs[2][1] == 0
    return pat


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_vaf_counter_under_debug(chunk, patterns, tmp_path, monkeypatch):
    """vaf-counter on sampleA1: the same VAF file with the switch unset,
    under it, and from the JAX tool under it; the port's ladder at its
    default chunk and at a small one, where it merges."""
    files = []
    for pkg, debug in (("kmer_tpu", True), ("kmer_tpu_torch", False),
                       ("kmer_tpu_torch", True)):
        vaf = str(tmp_path / f"{len(files)}.vaf")
        with monkeypatch.context() as m:
            m.setenv("KMER_TPU_PLATFORM", "cpu")
            if pkg == "kmer_tpu_torch" and chunk == "small":
                m.setattr(TC, "_STREAM_CHUNK", 1 << 16)
            if debug:
                m.setenv("KMER_TPU_DEBUG", "1")
            else:
                _no_general(m)
            before = TC.DEBUG_CHECKS["counts_for"]
            rc = _tool(pkg, "vaf-counter", ["-k21", "-p", patterns, "-o",
                                            vaf, SAMPLE])[0]
            n_checks = TC.DEBUG_CHECKS["counts_for"] - before
        assert rc == 0
        files.append(_read(vaf))
        assert n_checks == (pkg == "kmer_tpu_torch" and debug)
    assert files[0] == files[1] == files[2] and files[0].count(b"\n") > 100


# -- fault injection ----------------------------------------------------

def _seghist_fault(real):
    """The seghist twin with one count moved from its first filled bin
    to the next one."""
    def faulty(k, w, cfg):
        hist, nd = real(k, w, cfg)
        b = int(torch.nonzero(hist[1:-1])[0]) + 1
        hist = hist.clone()
        hist[b] -= 1
        hist[b + 1] += 1
        return hist, nd
    return faulty


def _merge_fault(real):
    """The merge twin with two adjacent lanes swapped where the first
    ends a run of two or more keys, so the run splits (in every merge
    that has such a place)."""
    def faulty(a, b):
        out = real(a, b).clone()
        at = torch.nonzero((out[1:-1] != out[2:]) & (out[1:-1] == out[:-2]))
        if at.shape[0]:
            i = int(at[0]) + 1
            out[i], out[i + 1] = out[i + 1].clone(), out[i].clone()
        return out
    return faulty


def _join_fault(real):
    """The binary-search join with the first query's count one higher."""
    def faulty(k, c, q):
        out = real(k, c, q).clone()
        out[0] += 1
        return out
    return faulty


FAULTS = {
    "seghist": (seghist, "segment_hist_sorted_plain", _seghist_fault,
                "Pallas/XLA histogram mismatch: bin"),
    "merge": (merge, "merge_runs_plain", _merge_fault,
              "Pallas/XLA histogram mismatch"),
    "join": (TC, "_counts_for_bs", _join_fault,
             "counts_for binary-search/sort-join mismatch: query 0"),
}


@pytest.mark.parametrize("debug", [True, False], ids=["debug", "unset"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_caught_only_under_debug(fault, debug, tmp_path,
                                          monkeypatch):
    """An injected fault raises AssertionError naming KMER_TPU_DEBUG (and
    the shape of the mismatch) under the switch; without it the tool
    finishes with exit 0 and no word of it."""
    mod, name, wrap, message = FAULTS[fault]
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(TC, "_STREAM_CHUNK", 1 << 15)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    if debug:
        monkeypatch.setenv("KMER_TPU_DEBUG", "1")
    if fault == "join":
        pat = tmp_path / "p.pat"
        pat.write_text("chr1\t100\t101\trs1\tA\tC\tACGTACGTACGTACGTACGTA\t"
                       "ACGTACGTACCTACGTACGTA\n")
        args = ("vaf-counter", ["-k21", "-p", str(pat), "-o",
                                str(tmp_path / "s.vaf"), READS])
    else:
        args = ("kc-c4", ["-k31", READS])
    if debug:
        with pytest.raises(AssertionError, match="KMER_TPU_DEBUG: " + message):
            _tool("kmer_tpu_torch", *args)
    else:
        rc, out, _ = _tool("kmer_tpu_torch", *args)
        assert rc == 0 and (fault == "join" or len(out.splitlines()) == 255)
