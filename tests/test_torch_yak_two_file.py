"""Two-file yak-count of the port (kmer_tpu_torch.kernels.bloom's bits
array, kmer_tpu_torch.pipeline.yak's SortYakEngine and shrink join,
kmer_tpu_torch.tools.yak_count's two-file branch) against the JAX
package on the CPU, and the sequential bloom against a lane-by-lane
oracle.

Inputs are made with numpy from a seed; the same inputs go to both
packages.  Every output is an integer: every comparison is exact
(tolerance 0).  Each JAX CLI run is computed once per module."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import bloom as jbloom
from kmer_tpu.kernels import u64
from kmer_tpu.pipeline import yak as jyak
from kmer_tpu_torch.kernels import bloom, keys
from kmer_tpu_torch.pipeline import yak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")
U32 = 0xFFFFFFFF


def _keys(rng, n, n_distinct, key_bits=62, sent_frac=0.05):
    """uint64 keys drawn with repeats from a pool, some all-ones."""
    pool = rng.integers(0, 1 << key_bits, n_distinct, dtype=np.uint64)
    if key_bits == 64:
        pool |= np.uint64(1 << 63)
    k = pool[rng.integers(0, n_distinct, n)]
    k[rng.random(n) < sent_frac] = np.uint64((1 << 64) - 1)
    return k


def _jax_keys(k):
    return u64.U64(jnp.asarray((k >> np.uint64(32)).astype(np.uint32)),
                   jnp.asarray((k & np.uint64(U32)).astype(np.uint32)))


def _specs(pre, n_shift, n_hashes):
    return (jbloom.BloomSpec(pre, n_shift, n_hashes),
            bloom.BloomSpec(pre, n_shift, n_hashes))


# -- the bloom's bits array ---------------------------------------------

SPECS = [(0, 9, 4), (4, 14, 4), (4, 20, 3), (10, 22, 1), (4, 16, 40)]


@pytest.mark.parametrize("fn", ["insert", "insert_sequential", "test"])
@pytest.mark.parametrize("pre,n_shift,n_hashes", SPECS)
def test_bloom_matches_jax(fn, pre, n_shift, n_hashes):
    """Over three blocks that carry the bits array: each lane's verdict
    and, after each block, the whole bits array (unpacked: the port's is
    packed, JAX's a byte a bit) equal JAX's; keys with the top bit set
    (k = 32), repeats across and within blocks, invalid lanes, and -H40,
    where one key probes one bit twice."""
    rng = np.random.default_rng(pre * 1000 + n_shift * 10 + n_hashes)
    jspec, spec = _specs(pre, n_shift, n_hashes)
    jbits = jbloom.make_bits(jspec)
    bits = bloom.make_bits(spec)
    assert bits.dtype == torch.uint8 and bits.shape[0] * 8 == jbits.shape[0]
    assert not bits.any()
    # one pool for all blocks, half of it with the top bit set
    allk = _keys(rng, 9000, 1500, key_bits=40)
    allk[allk != np.uint64(U32 << 32 | U32)] ^= np.uint64(1 << 63) * (
        rng.random(9000) < 0.5)[allk != np.uint64(U32 << 32 | U32)]
    for block in range(3):
        k = allk[block * 3000:(block + 1) * 3000]
        valid = k != np.uint64((1 << 64) - 1)
        valid[rng.random(k.shape[0]) < 0.02] = False
        tk = torch.from_numpy(keys.from_u64(k))
        tv = torch.from_numpy(valid)
        if fn == "test":
            want = jbloom.test(jbits, _jax_keys(k), jnp.asarray(valid), jspec)
            got = bloom.test(bits, tk, tv, spec)
            # set some bits for the next block's test
            jbits, _ = jbloom.insert(jbits, _jax_keys(k), jnp.asarray(valid),
                                     jspec)
            bloom.insert(bits, tk, tv, spec)
        else:
            jbits, want = getattr(jbloom, fn)(jbits, _jax_keys(k),
                                              jnp.asarray(valid), jspec)
            out, got = getattr(bloom, fn)(bits, tk, tv, spec)
            assert out is bits
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(bloom.unpack_bits(bits).numpy(),
                              np.asarray(jbits))
    if fn != "test":
        assert got.any() and not got.all()


def _sequential_oracle(bits, idxs, valid):
    """yak_bf_insert lane by lane (yak-count.c:91-108): each probe is
    tested, then set (`cnt += !!(*q & u); *q |= u;`), so a lane that
    probes one bit twice finds it set the second time."""
    bits = bits.copy()
    preset = np.zeros(valid.shape[0], bool)
    for i in np.flatnonzero(valid):
        cnt = 0
        for ix in idxs:
            cnt += int(bits[ix[i]])
            bits[ix[i]] = 1
        preset[i] = cnt == len(idxs)
    return bits, preset


@pytest.mark.parametrize("n_hashes", [4, 40])
def test_insert_sequential_matches_lane_by_lane_oracle(n_hashes):
    """The sequential bloom equals the reference's loop (the oracle of
    tests/test_count_table.py:135-175, with test-after-set inside a
    lane), over two blocks; the batched insert differs from it on the
    same collision-heavy input (one 512-bit block)."""
    spec = bloom.BloomSpec(pre=0, n_shift=9, n_hashes=n_hashes)
    rng = np.random.default_rng(42 + n_hashes)
    bits = bloom.make_bits(spec)
    want_bits = np.zeros(bits.shape[0] * 8, np.uint8)
    batched_differs = False
    for _ in range(2):
        n = 1500
        k = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        valid = np.ones(n, bool)
        valid[rng.integers(0, n, 50)] = False
        tk = torch.from_numpy(keys.from_u64(k))
        tv = torch.from_numpy(valid)
        idxs = [ix.numpy() for ix in bloom.probe_indices(tk, spec)]
        if n_hashes == 40:
            assert any((a == b).any() for j, a in enumerate(idxs)
                       for b in idxs[:j])
        _, batched = bloom.insert(bits.clone(), tk, tv, spec)
        want_bits, want = _sequential_oracle(want_bits, idxs, valid)
        _, got = bloom.insert_sequential(bits, tk, tv, spec)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(bloom.unpack_bits(bits).numpy(), want_bits)
        batched_differs |= not np.array_equal(batched.numpy(), want)
    assert batched_differs


# -- the shrink join ----------------------------------------------------

def _sorted_padded(k, pad):
    """Sorted unique keys, then `pad` all-ones lanes (a JAX compactor
    run's layout)."""
    return np.concatenate([np.sort(k),
                           np.full(pad, (1 << 64) - 1, np.uint64)])


@pytest.mark.parametrize("min_count,max_count", [(2, 1023), (1, 1023),
                                                 (5, 40)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shrink_join_matches_jax(seed, min_count, max_count):
    """Runs of unique keys (A: pass-1 keys; B: pass-2 keys with uint32
    counts, saturated ones, counts past 2^31 and 0), A keys absent from
    B, B keys absent from A, the top key bit set; A and B may end in
    all-ones lanes (JAX's padding), which never count.  hist (bin 0
    aside) and tot equal JAX's."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, 1 << 64, 40_000, dtype=np.uint64))
    pool = pool[pool != np.uint64((1 << 64) - 1)]
    rng.shuffle(pool)
    pad = 77 * seed
    a = _sorted_padded(pool[:20_000], pad)
    b = _sorted_padded(np.concatenate([pool[:15_000], pool[25_000:30_000]]),
                       pad)
    c2 = rng.integers(0, 60, b.shape[0]).astype(np.uint32)
    c2[rng.random(b.shape[0]) < 0.05] = rng.integers(1023, 5000)
    c2[:10] = [U32, 1 << 31, 1023, 1024, 0, 1, 2, 3, 2000, (1 << 31) + 7]
    c2[b.shape[0] - pad:] = 0
    ja, jb = _jax_keys(a), _jax_keys(b)
    jh, jtot = jyak._shrink_join_core(ja.hi, ja.lo, jb.hi, jb.lo,
                                      jnp.asarray(c2), jnp.uint32(min_count),
                                      jnp.uint32(max_count))
    th, ttot = yak._shrink_join_core(
        torch.from_numpy(keys.from_u64(a)), torch.from_numpy(keys.from_u64(b)),
        torch.from_numpy(c2.view(np.int32)), min_count, max_count)
    want = np.asarray(jh).astype(np.int64)
    assert th.dtype == torch.int64 and th.shape == (1024,)
    assert np.array_equal(th.numpy()[1:], want[1:])
    assert int(ttot) == int(jtot) > 0


def test_shrink_and_hist_without_pass_two():
    """shrink with comp2 None (the host min filter) and hist after -b0
    give JAX's numbers on the same admitted keys."""
    rng = np.random.default_rng(3)
    k = _keys(rng, 20_000, 3000, sent_frac=0.1)
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            eng = jyak.SortYakEngine(k=31)
            eng.comp1.add_raw(*_jax_keys(k))
        else:
            eng = yak.SortYakEngine(k=31, device="cpu")
            eng.comp1.add_raw(torch.from_numpy(keys.from_u64(k)))
        h1 = np.asarray(eng.hist()).copy()
        eng.shrink(3, 9)
        out.append((h1.tolist(), np.asarray(eng.hist()).tolist(), eng.tot))
    assert out[0] == out[1] and out[0][2] > 0


# -- the engine and the tool ----------------------------------------------

def test_engine_state_matches_jax():
    """The engine's pass-1 run (admitted keys and counts), its batches
    and its histogram after the shrink equal JAX's, at -p11 and a chunk
    size that makes several batches."""
    k, pre, b = 31, 11, 19
    out = []
    for eng in (jyak.SortYakEngine(k=k, pre=pre, bf_shift=b,
                                   chunk_size=300_000, log=lambda *a: None),
                yak.SortYakEngine(k=k, pre=pre, bf_shift=b,
                                  chunk_size=300_000, device="cpu",
                                  log=lambda *a: None)):
        eng.count([A1], create_new=True)
        batches1 = eng.batch_seq_counts
        eng.comp1.compact()
        n1 = eng.comp1.last_n_unique
        if isinstance(eng, yak.SortYakEngine):
            kk, c = eng.comp1.runs[0]
            hi, lo = keys.to_hi_lo(kk)
            c = c.numpy().view(np.uint32)
        else:  # JAX pads its run with all-ones lanes
            hi, lo, c = (np.asarray(x)[:n1] for x in eng.comp1.runs[0])
        eng.destroy_bloom()
        eng.clear()
        eng.count([B], create_new=False)
        eng.shrink(2, 1023)
        out.append((hi.tolist(), lo.tolist(), c.tolist(), n1, batches1,
                    eng.batch_seq_counts, np.asarray(eng.hist()).tolist(),
                    eng.tot))
    assert out[0] == out[1]
    assert len(out[0][4]) > 1 and len(out[0][5]) > 1


CLI_CASES = {
    "k31": ("", ["-k31", "-b19"]),
    "k21_K200000": ("", ["-k21", "-b19", "-K200000"]),
    "k15": ("", ["-k15", "-b19"]),
    "b0": ("", ["-b0"]),
    "b15_bloom_off": ("", ["-b15"]),
    "not_exact": ("0", ["-k21", "-b19", "-K200000"]),
}
_want = {}


def _yak(pkg, args, capsys):
    """(rc, stdout, the `[M`/`[W`/`Error` stderr lines) of one run."""
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, [ln for ln in cap.err.splitlines()
                         if ln.startswith(("[M", "[W", "Error"))]


def _jax_want(name, argv, capsys, monkeypatch):
    if name not in _want:
        with monkeypatch.context() as m:
            exact = CLI_CASES[name][0] if name in CLI_CASES else ""
            if exact:
                m.setenv("KMER_TPU_EXACT_BLOOM", exact)
            _want[name] = _yak("kmer_tpu", argv, capsys)
    return _want[name]


@pytest.mark.parametrize("name,chunk", [
    *((name, "default") for name in CLI_CASES),
    ("k31", "small"), ("k21_K200000", "small"), ("k15", "small")])
def test_two_file_cli_matches_jax(name, chunk, capsys, monkeypatch):
    """stdout (1023 rows) and every `[M` line equal the JAX package's:
    k = 31, 21 and 15 (one-plane), one batch and several, -b0 (one pass,
    no shrink), -b15 (bloom disabled by its geometry, two passes all the
    same), and KMER_TPU_EXACT_BLOOM=0 (the batched insert); the stream
    ladders at their default chunk, and at a small one, where they merge,
    for both key layouts and for several batches."""
    exact, args = CLI_CASES[name]
    argv = [*args, A1, B]
    want = _jax_want(name, argv, capsys, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    if exact:
        monkeypatch.setenv("KMER_TPU_EXACT_BLOOM", exact)
    if chunk == "small":
        from kmer_tpu_torch.table import compactor

        monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 15)
    got = _yak("kmer_tpu_torch", argv, capsys)
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    assert got == want
    n_m = sum(ln.startswith("[M] ") for ln in got[2])
    if name == "b0":
        assert n_m == 1  # pass 1 only
    elif "-K200000" in args:
        assert n_m > 2  # several batches a pass
    else:
        assert n_m == 2  # one batch a pass


@pytest.mark.parametrize("which", ["second", "first"])
def test_two_file_unopenable_input(which, capsys, monkeypatch):
    """An input that cannot be opened: `Error: failed to open <it>` and
    exit 1, after pass 1's `[M` lines when it is the second file, as in
    JAX."""
    bad = "/nonexistent/sample.fq.gz"
    argv = ["-k31", "-b19", *([A1, bad] if which == "second"
                              else [bad, B])]
    want = _jax_want(f"missing_{which}", argv, capsys, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _yak("kmer_tpu_torch", argv, capsys)
    assert got == want
    assert got[0] == 1 and got[1] == ""
    assert got[2][-1] == f"Error: failed to open {bad}"
    assert len(got[2]) == (2 if which == "second" else 1)


def test_two_file_device_failure_is_not_an_open_failure(capsys, monkeypatch):
    """An OSError past the reader (here from the compactor) propagates:
    the `failed to open` handler covers the reader only."""
    from kmer_tpu_torch.table.compactor import KmerCompactor
    from kmer_tpu_torch.tools import get_tool

    def broken(*a, **kw):
        raise OSError("not a reader error")

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(KmerCompactor, "add_raw", broken)
    with pytest.raises(OSError, match="not a reader error"):
        get_tool("yak-count")(["-k31", "-b19", A1, B])
    assert "failed to open" not in capsys.readouterr().err


def test_make_bloom_and_exact_default(monkeypatch):
    """_make_bloom's gates, bits array and exact flag equal JAX's for a
    bloom JAX holds (bits: packed, an eighth of JAX's length; the dummy
    is 8 bytes), KMER_TPU_EXACT_BLOOM read as JAX reads it.  Above 2^31
    bits (-b37 at -p25, -b33 at -p10) SortYakEngine's geometry keeps the
    -b asked for and its packed bits are 2^(b - 3) bytes (made on the
    meta device), where the clamping engines cut to 2^31 bits as JAX
    does (at -p25 that leaves no block a subtable: no bloom)."""
    cases = [(10, 19, 4), (10, 15, 4), (10, 0, 4), (10, 20, 0), (25, 37, 4),
             (10, 33, 2)]
    for env in ("", "0", "off", "1", "yes"):
        if env:
            monkeypatch.setenv("KMER_TPU_EXACT_BLOOM", env)
        for pre, b, h in cases:
            if b > 31:
                want = jyak._make_bloom(pre, b, h, make_bits_array=False)
                got = yak._make_bloom(pre, b, h, device="meta",
                                      max_shift=yak.SORT_MAX_SHIFT)
                assert got[0] and got[1] == b
                assert tuple(got[2]) == (pre, b, h, 0)
                assert got[3].shape == (1 << (b - 3),)
                assert got[3].dtype == torch.uint8
                assert got[4] == jyak._exact_bloom_default(True)
                clamped = yak._make_bloom(pre, b, h, make_bits_array=False)
                assert clamped[:2] == want[:2] and clamped[4] == want[4]
                assert (None if clamped[2] is None else tuple(clamped[2])) \
                    == (None if want[2] is None else tuple(want[2]))
                continue
            want = jyak._make_bloom(pre, b, h)
            for max_shift in (yak.CLAMP_SHIFT, yak.SORT_MAX_SHIFT):
                got = yak._make_bloom(pre, b, h, device="cpu",
                                      max_shift=max_shift)
                assert got[0] == want[0] and got[1] == want[1]
                assert got[4] == want[4]
                assert (got[2] is None) == (want[2] is None)
                if got[2] is not None:
                    assert tuple(got[2]) == tuple(want[2])
                    assert got[3].shape[0] * 8 == want[3].shape[0]
                else:
                    assert got[3].shape == want[3].shape
                assert not got[3].any()


def test_tap_admit_matches_jax():
    """_tap_admit: admitted lanes keep their key, the rest become the
    sentinel; the bits array after it equals JAX's; without a bloom the
    keys pass through."""
    rng = np.random.default_rng(9)
    k = _keys(rng, 8000, 2500)
    jspec, spec = _specs(10, 22, 4)
    for use_bloom, exact in ((True, True), (True, False), (False, False)):
        jbits = jbloom.make_bits(jspec)
        bits = bloom.make_bits(spec)
        for part in (k[:5000], k[5000:]):
            jk = _jax_keys(part)
            jhi, jlo, jbits = jyak._tap_admit(jbits, jk.hi, jk.lo, jspec,
                                              use_bloom, exact)
            got, bits = yak._tap_admit(
                bits, torch.from_numpy(keys.from_u64(part)), spec,
                use_bloom, exact)
            hi, lo = keys.to_hi_lo(got)
            assert np.array_equal(hi, np.asarray(jhi))
            assert np.array_equal(lo, np.asarray(jlo))
            assert np.array_equal(bloom.unpack_bits(bits).numpy(),
                                  np.asarray(jbits))
