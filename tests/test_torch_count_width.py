"""Weighted key totals at the edges of the uint32 count width, end to end
on the CPU, against the JAX package.

A key's total is the sum of its counts mod 2^32, read as uint32, as the
JAX package's XLA histogram (`_hist_xla_core`) reads it: a total in
[2^31, 2^32) lands in the last bin, exactly 2^32 wraps to 0 and is
dropped, 2^32 + 3 lands in bin 3.  Counted input reaches such totals
through a resumed checkpoint and further counted runs.  Every comparison
is exact (integer outputs, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import u64 as U
from kmer_tpu.pipeline import counter as jcounter
from kmer_tpu.table import compactor as JC
from kmer_tpu_torch.dist import sharded
from kmer_tpu_torch.kernels import keys
from kmer_tpu_torch.pipeline import counter
from kmer_tpu_torch.table import compactor as TC

EDGES = (1 << 31, 0x90000000, (1 << 32) - 1, 1 << 32, (1 << 32) + 3)
CFGS = ((256, None, 1), (256, 255, 2), (1024, 1023, 2))
SHARDS = 8
U32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counted_input(rng, k, n_keys=3000):
    """Two counted runs (hi, lo, uint32 counts) over n_keys distinct keys
    below 2^(2k).  The first, the one checkpointed, holds every key but
    the last 200, most with small counts; the second holds half of them
    again and the last 200 with small counts.  Four keys for each edge
    total have a first part in [2^31, 2^32) and the rest in the second
    run; five more hold a count in [2^31, 2^32) in the first run alone."""
    u = np.unique(rng.integers(0, 1 << (2 * k), size=n_keys + 500,
                               dtype=np.uint64))[:n_keys]
    u = rng.permutation(u)
    c1 = rng.integers(1, 9, size=n_keys, dtype=np.uint64)
    c2 = rng.integers(1, 9, size=n_keys, dtype=np.uint64)
    in2 = rng.random(n_keys) < 0.5
    in2[-200:] = True
    wide = np.arange(4 * len(EDGES) + 5)
    c1[wide] = rng.integers(1 << 31, 1 << 32, size=wide.size,
                            dtype=np.uint64)
    for i, total in enumerate(np.repeat(EDGES, 4)):
        c2[i] = (total - int(c1[i])) % (1 << 32)
    in2[wide] = wide < 4 * len(EDGES)
    r1 = slice(0, n_keys - 200)

    def run(sel, c):
        return ((u[sel] >> np.uint64(32)).astype(np.uint32),
                (u[sel] & np.uint64(U32)).astype(np.uint32),
                c[sel].astype(np.uint32))

    return run(r1, c1), run(in2, c2)


def _mesh_checkpoint(path, k, run, mesh):
    """`run` written in the JAX package's mesh layout (uint32 hi / lo /
    cnt of shape (data, shard, L), each key in its owner's row, the
    sentinel with count 0 past each shard's keys; meta = [k, kmers,
    dropped]), as MeshSortCountEngine.save_checkpoint writes one."""
    d, s = mesh.shape["data"], mesh.shape["shard"]
    hi, lo, cnt = (np.full((d, s, 1 << 16), v, np.uint32)
                   for v in (U32, U32, 0))
    for j in range(d * s):
        own = (run[1] & (d * s - 1)) == j
        n = int(own.sum())
        for plane, src in zip((hi, lo, cnt), run):
            plane[divmod(j, s)][:n] = src[own]
    np.savez_compressed(path, hi=hi, lo=lo, cnt=cnt,
                        meta=np.asarray([k, 0, 0], np.int64))


def _add_counted(comp, run, own=None):
    hi, lo, cnt = (p if own is None else p[own] for p in run)
    comp.add_counted(keys.from_hi_lo(hi, lo, comp.device),
                     torch.from_numpy(cnt.view(np.int32)))


@pytest.mark.parametrize("k, fold", [
    pytest.param(21, False, id="21"), pytest.param(15, False, id="15"),
    pytest.param(21, True, id="21-fold"), pytest.param(15, True, id="15-fold")])
def test_counted_totals_past_int32_match_jax(k, fold, tmp_path, monkeypatch):
    """A checkpoint that the JAX package wrote, resumed by the port's
    SortCountEngine, and the same counts restored into a ShardedSortEngine
    of 8 CPU shards in the JAX mesh layout, then a further counted run
    into each: every histogram (kc's and yak-count's bins_cfg) == the JAX
    KmerCompactor.hist of both runs, bins and n_distinct, two-plane at
    k = 21 and one-plane at k = 15, with KMER_TPU_DEBUG unset and set
    (no check raises; the single engine checks once, each shard once).
    With `fold`, the resumed counts are compacted into the standing plane
    first, so the edge totals form in the fold's merge and reduce."""
    rng = np.random.default_rng(k)
    r1, r2 = _counted_input(rng, k)
    jc = JC.KmerCompactor(key_bits=2 * k)
    for hi, lo, cnt in (r1, r2):
        jc.add_counted(U.U64(jnp.asarray(hi), jnp.asarray(lo)),
                       jnp.asarray(cnt))
    want = {cfg: jc.hist(*cfg) for cfg in CFGS}
    wide = sum(1 << 31 <= e % (1 << 32) for e in EDGES) * 4 + 5
    assert all(h[-1] >= wide for h, _ in want.values())

    path = str(tmp_path / "single.npz")
    je = jcounter.SortCountEngine(k=k)
    je.compactor.add_counted(U.U64(jnp.asarray(r1[0]), jnp.asarray(r1[1])),
                             jnp.asarray(r1[2]))
    je.save_checkpoint(path)
    single = counter.SortCountEngine.resume_checkpoint(path, device="cpu")
    mesh = sharded.make_mesh([torch.device("cpu")] * SHARDS)
    mesh_path = str(tmp_path / "mesh.npz")
    _mesh_checkpoint(mesh_path, k, r1, mesh)
    shards = sharded.ShardedSortEngine(mesh, k)
    shards.restore_checkpoint(mesh_path)
    if fold:
        single.compactor.compact()
        shards.compact()
    _add_counted(single.compactor, r2)
    for j, comp in enumerate(shards.shards):
        _add_counted(comp, r2, (r2[1] & (SHARDS - 1)) == j)
    assert all(comp.runs for comp in shards.shards)
    assert single.compactor._standing is fold

    for debug in ("", "1"):
        monkeypatch.setenv("KMER_TPU_DEBUG", debug)
        for eng, n_checks in ((single, 1), (shards, SHARDS)):
            for cfg in CFGS:
                before = TC.DEBUG_CHECKS["hist"]
                h = eng.hist(*cfg)
                assert np.array_equal(h, want[cfg][0])
                assert eng._n_distinct == want[cfg][1]
                assert TC.DEBUG_CHECKS["hist"] - before == (
                    n_checks if debug else 0)
