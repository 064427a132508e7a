"""The port's open-addressing count table (kmer_tpu_torch.table.count_table
and the plain slot resolution of kmer_tpu_torch.kernels.table) against
the JAX package's kmer_tpu.table.count_table on the CPU.

The same seeded numpy keys go through both; the table planes (state,
keys as hi / lo, cnt), n_full and every resolve output (slot, found,
created) must be equal: every value is an integer, so the tolerance is
0.  The slot layout follows from slot_mix32 and the round arbitration,
so equal planes show both are the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kmer_tpu.kernels import u64
from kmer_tpu.kernels.hash64 import slot_mix32 as jslot_mix32
from kmer_tpu.table import count_table as _jct
from kmer_tpu_torch.kernels import keys as keys_mod
from kmer_tpu_torch.kernels import table as kt
from kmer_tpu_torch.kernels.hash64 import HASH64_K32_ZERO, slot_mix32
from kmer_tpu_torch.table import count_table as ct

class jct:
    """The JAX package's count_table, each operation jitted once per shape
    (the loop is traced once, not at every call); the functions are
    the package's own."""
    make = staticmethod(_jct.make)
    resolve_slots = staticmethod(jax.jit(_jct.resolve_slots,
                                         static_argnums=(3,)))
    insert = staticmethod(jax.jit(_jct.insert, static_argnums=(3,)))
    insert_gated = staticmethod(jax.jit(_jct.insert_gated,
                                        static_argnums=(4,)))
    add_existing = staticmethod(jax.jit(_jct.add_existing,
                                        static_argnums=(3,)))
    get = staticmethod(jax.jit(_jct.get))
    hist = staticmethod(jax.jit(_jct.hist, static_argnums=(1,)))
    clear_counts = staticmethod(_jct.clear_counts)
    rebuild = staticmethod(jax.jit(_jct.rebuild, static_argnums=(1, 2, 3)))


U32 = 0xFFFFFFFF
ALL_ONES = np.uint64((1 << 64) - 1)
GROW_LOAD = 0.65


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkeys(k):
    return u64.U64(jnp.asarray((k >> np.uint64(32)).astype(np.uint32)),
                   jnp.asarray((k & np.uint64(U32)).astype(np.uint32)))


def _tkeys(k):
    return torch.from_numpy(keys_mod.from_u64(k))


def _pool(rng, n, key_bits=62):
    return rng.integers(0, 1 << key_bits, n, dtype=np.uint64)


def _assert_tables_equal(t, jt):
    state, hi, lo, cnt = ct.to_jax_planes(t)
    assert np.array_equal(state, np.asarray(jt.state))
    assert np.array_equal(hi, np.asarray(jt.key_hi))
    assert np.array_equal(lo, np.asarray(jt.key_lo))
    assert np.array_equal(cnt, np.asarray(jt.cnt))
    assert int(t.n_full) == int(jt.n_full)


def _filled(rng, cap, load, max_count=None):
    """(JAX table, port table) holding about load * cap keys, inserted
    in one batch with repeats, equal plane for plane."""
    n = int(load * cap)
    pool = _pool(rng, n)
    draw = pool[rng.integers(0, n, 2 * n)]
    draw[:n] = pool  # every pool key at least once
    jt, _ = jct.insert(jct.make(cap), _jkeys(draw),
                       jnp.ones(draw.shape[0], bool), max_count)
    t, _ = ct.insert(ct.make(cap), _tkeys(draw),
                     torch.ones(draw.shape[0], dtype=torch.bool), max_count)
    _assert_tables_equal(t, jt)
    return jt, t, pool


def _shared_base(rng, cap, n, base=5):
    """n distinct keys whose slot mix lands on one base slot."""
    out = []
    while len(out) < n:
        k = _pool(rng, 1 << 16)
        b = (slot_mix32(_tkeys(k)) & (cap - 1)).numpy()
        out.extend(k[b == base].tolist())
    return np.unique(np.asarray(out[:n], np.uint64))


def _batch(rng, name, cap, pool):
    """(keys, valid) of one test batch over a table of cap slots whose
    keys are `pool`."""
    m = 3000
    if name == "fresh":
        k = _pool(rng, 400)[rng.integers(0, 400, m)]
    elif name == "dup_heavy":
        k = _pool(rng, 7)[rng.integers(0, 7, m)]
    elif name == "shared_base":
        k = _shared_base(rng, cap, 40)
        k = k[rng.integers(0, k.shape[0], m)]
    elif name == "mixed_old_new":  # half keys already in the table
        k = np.concatenate([pool, _pool(rng, 300)])
        k = k[rng.integers(0, k.shape[0], m)]
    elif name == "k32":  # every valid k = 32 window's key
        k = np.full(m, HASH64_K32_ZERO, np.uint64)
    else:
        raise ValueError(name)
    valid = rng.random(m) > 0.1  # invalid lanes, some holding all-ones
    k[~valid & (rng.random(m) < 0.5)] = ALL_ONES
    return k, valid


def test_slot_mix32_matches_jax():
    """Bit for bit, over random keys, keys with the top bit set, 0, the
    all-ones sentinel and k = 32's constant."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 64, 50_000, dtype=np.uint64)
    k[:4] = [0, ALL_ONES, 1 << 63, HASH64_K32_ZERO]
    want = np.asarray(jslot_mix32(_jkeys(k))).astype(np.int64)
    got = slot_mix32(_tkeys(k))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


BATCHES = ["fresh", "dup_heavy", "shared_base", "mixed_old_new", "k32"]


@pytest.mark.parametrize("create_new", [True, False])
@pytest.mark.parametrize("load", [0.0, 0.6])
@pytest.mark.parametrize("name", BATCHES)
def test_resolve_slots_matches_jax(name, load, create_new):
    """slot, found, created and the planes after one resolve, on a fresh
    table and one near GROW_LOAD; lookups (create_new off) resolve absent
    keys to slot == cap."""
    rng = np.random.default_rng(BATCHES.index(name) * 10 + int(10 * load))
    cap = 1024
    if load:
        jt, t, pool = _filled(rng, cap, load)
    else:
        jt, t, pool = jct.make(cap), ct.make(cap), _pool(rng, 10)
    k, valid = _batch(rng, name, cap, pool)
    jr = jct.resolve_slots(jt, _jkeys(k), jnp.asarray(valid), create_new)
    r = ct.resolve_slots(t, _tkeys(k), torch.from_numpy(valid), create_new)
    assert np.array_equal(r.slot.numpy(), np.asarray(jr.slot))
    assert np.array_equal(r.found.numpy(), np.asarray(jr.found))
    assert np.array_equal(r.created.numpy(), np.asarray(jr.created))
    _assert_tables_equal(r.table, jr.table)
    if not create_new:
        assert not r.created.any()
        assert (r.slot.numpy() == cap).any()  # absent or invalid lanes


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("max_count", [None, 5])
def test_insert_matches_jax(weighted, max_count):
    """Four batches into one table (grown in between as the engines
    grow it): the planes, n_full and n_new after each, weighted (uint32
    weights, some past 2^31, so counts wrap) or not, saturating or
    not."""
    rng = np.random.default_rng(int(weighted) * 2 + (max_count or 0))
    pool = _pool(rng, 600)
    jt, t = jct.make(256), ct.make(256)
    for b in range(4):
        k = pool[rng.integers(0, 150 * (b + 1), 2000)]
        valid = rng.random(2000) > 0.05
        w = rng.integers(0, 4, 2000).astype(np.uint32)
        if weighted:
            w[rng.random(2000) < 0.01] = rng.integers(1 << 31, 1 << 32)
        cap = t.capacity
        while int(t.n_full) + int(valid.sum()) > GROW_LOAD * cap:
            cap *= 2
        if cap != t.capacity:
            jt, t = jct.rebuild(jt, cap), ct.rebuild(t, cap)
            _assert_tables_equal(t, jt)
        jw = jnp.asarray(w) if weighted else None
        tw = torch.from_numpy(w.view(np.int32)) if weighted else None
        jt, jn = jct.insert(jt, _jkeys(k), jnp.asarray(valid), max_count,
                            jw)
        t, n = ct.insert(t, _tkeys(k), torch.from_numpy(valid), max_count,
                         tw)
        assert int(n) == int(jn)
        _assert_tables_equal(t, jt)
    if max_count:
        assert int(t.cnt.max()) == max_count


@pytest.mark.parametrize("load", [0.0, 0.5])
def test_insert_gated_matches_jax(load):
    """Bloom-gated inserts with `preset` mixed: the first lane of a key
    adds only when preset, so some claimed slots roll back to DELETED;
    planes (tombstones included), n_new and n_dead equal JAX's over three
    batches, and the tombstones stay probe-opaque in the next batch."""
    rng = np.random.default_rng(17 + int(10 * load))
    cap = 2048
    if load:
        jt, t, pool = _filled(rng, cap, load)
    else:
        jt, t, pool = jct.make(cap), ct.make(cap), _pool(rng, 50)
    fresh = _pool(rng, 200)
    n_dead_total = 0
    for _ in range(3):
        k = np.concatenate([pool, fresh])[rng.integers(0, pool.shape[0]
                                                       + 200, 1500)]
        k[:100] = fresh[rng.integers(0, 200, 100)]
        valid = rng.random(1500) > 0.05
        preset = rng.random(1500) < 0.5
        jt, jn, jd = jct.insert_gated(jt, _jkeys(k), jnp.asarray(valid),
                                      jnp.asarray(preset), 1023)
        t, n, d = ct.insert_gated(t, _tkeys(k), torch.from_numpy(valid),
                                  torch.from_numpy(preset), 1023)
        assert (int(n), int(d)) == (int(jn), int(jd))
        n_dead_total += int(d)
        _assert_tables_equal(t, jt)
    assert n_dead_total > 0
    assert int((t.state == ct.DELETED).sum()) == n_dead_total


def test_add_existing_and_get_match_jax():
    """add_existing counts only keys present (absent keys change
    nothing), and get gives each lane's count or -1: on a table with
    tombstones, over present, absent and invalid lanes."""
    rng = np.random.default_rng(23)
    jt, t, pool = _filled(rng, 1024, 0.5)
    ghosts = _pool(rng, 100)
    jt, _, _ = jct.insert_gated(jt, _jkeys(ghosts), jnp.ones(100, bool),
                                jnp.zeros(100, bool), 1023)
    t, _, nd = ct.insert_gated(t, _tkeys(ghosts), torch.ones(100,
                                                              dtype=torch.bool),
                               torch.zeros(100, dtype=torch.bool), 1023)
    assert int(nd) == 100
    absent = _pool(rng, 300)
    k = np.concatenate([pool, absent, ghosts])[rng.integers(0, 900, 4000)]
    valid = rng.random(4000) > 0.1
    jt = jct.clear_counts(jt)
    t = ct.clear_counts(t)
    jt = jct.add_existing(jt, _jkeys(k), jnp.asarray(valid), 1023)
    t = ct.add_existing(t, _tkeys(k), torch.from_numpy(valid), 1023)
    _assert_tables_equal(t, jt)
    jg = jct.get(jt, _jkeys(k), jnp.asarray(valid))
    g = ct.get(t, _tkeys(k), torch.from_numpy(valid))
    assert np.array_equal(g.numpy(), np.asarray(jg))
    assert (g.numpy() == -1).any() and (g.numpy() > 0).any()


@pytest.mark.parametrize("new_cap,min_count,max_count", [
    (4096, 0, None), (1024, 0, None), (1024, 2, 1023), (2048, 3, 9)])
def test_rebuild_matches_jax(new_cap, min_count, max_count):
    """rebuild as a resize (larger, same size: the tombstones swept) and
    as a shrink keeping counts in [min_count, max_count]."""
    rng = np.random.default_rng(new_cap + min_count)
    jt, t, _pool_keys = _filled(rng, 1024, 0.55)
    ghosts = _pool(rng, 50)
    jt, _, _ = jct.insert_gated(jt, _jkeys(ghosts), jnp.ones(50, bool),
                                jnp.zeros(50, bool), None)
    t, _, _ = ct.insert_gated(t, _tkeys(ghosts), torch.ones(50,
                                                            dtype=torch.bool),
                              torch.zeros(50, dtype=torch.bool), None)
    jr = jct.rebuild(jt, new_cap, min_count, max_count)
    r = ct.rebuild(t, new_cap, min_count, max_count)
    _assert_tables_equal(r, jr)
    assert not (r.state == ct.DELETED).any()
    assert int(r.n_full) == int(ct.occupancy(r)) > 0


def test_hist_matches_jax():
    """The histogram over FULL slots, counts past n_bins - 1 in the last
    bin, DELETED and EMPTY slots not counted."""
    rng = np.random.default_rng(31)
    jt, t, pool = _filled(rng, 1024, 0.4)
    k = pool[rng.integers(0, 40, 5000)]  # a few keys with high counts
    jt, _ = jct.insert(jt, _jkeys(k), jnp.ones(5000, bool), None)
    t, _ = ct.insert(t, _tkeys(k), torch.ones(5000, dtype=torch.bool), None)
    for n_bins in (16, 1024):
        want = np.asarray(jct.hist(jt, n_bins)).astype(np.int64)
        got = ct.hist(t, n_bins)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
    assert int(ct.hist(t, 16)[15]) > 0


def test_resolve_raises_instead_of_spinning():
    """More distinct keys than slots: the JAX loop never ends; the port's
    raises after its round limit, both forms' shared check."""
    k = _tkeys(np.arange(1, 21, dtype=np.uint64))
    t = ct.make(8)
    with pytest.raises(RuntimeError, match="more distinct keys"):
        ct.insert(t, k, torch.ones(20, dtype=torch.bool), None)
    with pytest.raises(ValueError, match="power of two"):
        kt.resolve_slots_plain(torch.zeros(6, dtype=torch.uint8),
                               torch.zeros(6, dtype=torch.int64), k,
                               torch.ones(20, dtype=torch.bool), True)
    with pytest.raises(ValueError, match="CUDA"):
        kt.resolve_slots_kernel(t.state, t.key, k,
                                torch.ones(20, dtype=torch.bool), True)


def test_resolve_entry_points_match_their_signatures():
    """csrc/table.cu's C entry points, ktt_resolve (one cooperative
    launch a call) and ktt_resolve_info, have as many parameters as
    their ctypes signatures; the per-round entry is gone."""
    import os
    import re

    from kmer_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "table.cu")) as f:
        src = f.read()
    entries = {n: a for n, a in _build._SIGNATURES.items()
               if n.startswith("ktt_resolve")}
    assert set(entries) == {"ktt_resolve", "ktt_resolve_info"}
    for name, argtypes in entries.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), name
    assert "cudaLaunchCooperativeKernel" in src
    assert "ktt_resolve_round" not in src
