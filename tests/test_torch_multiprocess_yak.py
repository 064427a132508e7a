"""Runs of several processes on the port, part two: the per-process
checkpoint shards (kill and resume across two generations of two
processes, checkpoints crossing between the packages, the refusals) and
single-reader mode (KMER_TPU_SINGLE_READER=1: process 0 reads and
broadcasts), whose histogram and yak `[M` lines must equal a 1-process
run of the same eight-shard mesh.  Workers as in
tests/test_torch_multiprocess.py (two gloo processes of four CPU
shards); the JAX side runs in the test process on its eight virtual CPU
devices, or, for the JAX-written checkpoint, in two JAX processes of
four, as tests/test_multiprocess.py runs them.  Tolerance 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_multiprocess import (REPO, free_port, run_workers,
                                     write_fastq)

CPU8 = [torch.device("cpu")] * 8

CKPT = """
from kmer_tpu_torch.dist.multihost import MultihostSortEngine

phase, ckpt, path = args
eng = MultihostSortEngine(k=21, block_bases=65536)
if phase == "save":
    eng.count_paths([path])
    eng.save_checkpoint(ckpt)
else:
    eng.resume_checkpoint_into(ckpt)
    eng.count_paths([path])
    h = eng.hist(256, max_count=1023)
    result.update(hist=h.tolist(), nd=int(eng._n_distinct),
                  tb=eng.total_bases, ts=eng.total_seqs,
                  tk=eng.total_kmers)
"""

# the save phase of tests/test_multiprocess.py's _CKPT_WORKER
JAX_SAVE = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nproc, process_id=pid)
from kmer_tpu.dist.multihost import MultihostSortEngine
eng = MultihostSortEngine(k=21, block_bases=65536)
eng.count_paths([sys.argv[5]])
eng.save_checkpoint(sys.argv[4])
""".format(repo=REPO)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpy")
    rng = np.random.default_rng(11)
    paths = []
    # files of several 64 KiB buffers each: the single-reader run takes
    # three steps of eight rows, each split where the packer fills a row
    for i, n in enumerate((3000, 3500, 4000)):
        paths.append(str(tmp / f"f{i}.fq.gz"))
        write_fastq(paths[-1], rng, n, 120)
    return paths


@pytest.fixture(scope="module")
def single_engine(files):
    """The JAX SortCountEngine over the first two files."""
    from kmer_tpu.pipeline.counter import SortCountEngine

    eng = SortCountEngine(k=21)
    eng.count_paths(files[:2])
    return (eng.hist(256, max_count=1023).astype(np.int64),
            eng._n_distinct, eng.total_bases, eng.total_seqs,
            eng.total_kmers)


def _check_resumed(got, want):
    hist, nd, tb, ts, tk = want
    for g in got:
        assert np.array_equal(np.asarray(g["hist"]), hist)
        assert (g["nd"], g["tb"], g["ts"], g["tk"]) == (nd, tb, ts, tk)


def test_checkpoint_kill_and_resume(tmp_path, files, single_engine):
    """Generation 1 (two processes) counts file A, writes
    state.proc{0,1}of2.npz and exits; a fresh generation on a new port
    resumes and counts file B: hist and totals == one engine over both."""
    ckpt = str(tmp_path / "state.ckpt")
    run_workers(tmp_path, CKPT, ["save", ckpt, files[0]], name="gen1")
    assert os.path.exists(ckpt + ".proc0of2.npz")
    assert os.path.exists(ckpt + ".proc1of2.npz")
    got = run_workers(tmp_path, CKPT, ["resume", ckpt, files[1]],
                      name="gen2")
    _check_resumed(got, single_engine)


def test_jax_checkpoint_resumes_on_port(tmp_path, files, single_engine):
    """Two JAX processes (four virtual devices each) count file A and
    save; two port processes resume their files and count file B.  The
    JAX files' (di, si) planes are process-major, as the port's global
    shards are."""
    ckpt = str(tmp_path / "jax.ckpt")
    script = tmp_path / "jax_save.py"
    script.write_text(JAX_SAVE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", port, ckpt, files[0]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_o, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    z = np.load(ckpt + ".proc1of2.npz")
    assert sorted(n for n in z.files if n.startswith("hi_")) == [
        f"hi_1_{si}" for si in range(4)]
    got = run_workers(tmp_path, CKPT, ["resume", ckpt, files[1]],
                      name="resume")
    _check_resumed(got, single_engine)


def test_one_process_checkpoints_cross_packages(tmp_path, files,
                                                single_engine,
                                                monkeypatch):
    """In one process, eight port shards against the JAX package's eight
    virtual devices: both write the same proc0of1 file for file A, and
    each package resumes the other's and counts file B to the single
    engine's hist and totals."""
    from kmer_tpu.dist.multihost import MultihostSortEngine as JaxEngine
    from kmer_tpu_torch.dist.multihost import MultihostSortEngine

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    e = MultihostSortEngine(21, block_bases=65536, devices=CPU8)
    e.count_paths([files[0]])
    e.save_checkpoint(mine)
    j = JaxEngine(k=21, block_bases=65536)
    j.count_paths([files[0]])
    j.save_checkpoint(theirs)
    zm = np.load(mine + ".proc0of1.npz")
    zj = np.load(theirs + ".proc0of1.npz")
    assert sorted(zm.files) == sorted(zj.files)
    for name in zj.files:
        assert np.array_equal(zm[name], zj[name]), name
        assert zm[name].dtype == zj[name].dtype, name

    hist, nd, tb, ts, tk = single_engine
    j2 = JaxEngine(k=21, block_bases=65536)
    j2.resume_checkpoint_into(mine)
    j2.count_paths([files[1]])
    assert np.array_equal(np.asarray(j2.hist(256, max_count=1023)), hist)
    e2 = MultihostSortEngine(21, block_bases=65536, devices=CPU8)
    e2.resume_checkpoint_into(theirs)
    e2.count_paths([files[1]])
    assert np.array_equal(e2.hist(256, max_count=1023), hist)
    assert (e2._n_distinct, e2.total_bases, e2.total_seqs,
            e2.total_kmers) == (nd, tb, ts, tk)


@pytest.mark.parametrize("fault,match", [
    ("k", "k=21"), ("mesh", "mesh 2x4"), ("process", "process")])
def test_checkpoint_refusals(tmp_path, files, monkeypatch, fault, match):
    """k, the mesh shape and the process layout must match the saving
    run's, with the JAX package's ValueError messages, in both
    packages."""
    from kmer_tpu.dist.multihost import MultihostSortEngine as JaxEngine
    from kmer_tpu_torch.dist.multihost import MultihostSortEngine

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    ckpt = str(tmp_path / "s.ckpt")
    e = MultihostSortEngine(21, block_bases=65536, devices=CPU8)
    e.count_paths([files[0]])
    e.save_checkpoint(ckpt)
    if fault == "k":
        ports = [MultihostSortEngine(31, devices=CPU8)]
        jaxes = [JaxEngine(k=31)]
    elif fault == "mesh":
        ports = [MultihostSortEngine(21, devices=CPU8[:4])]
        jaxes = []  # its mesh is the conftest's eight devices
    else:
        z = dict(np.load(ckpt + ".proc0of1.npz"))
        z["meta"] = z["meta"].copy()
        z["meta"][3] = 2  # claim a 2-process run wrote it
        np.savez_compressed(ckpt + "2.proc0of1.npz", **z)
        ckpt += "2"
        ports = [MultihostSortEngine(21, devices=CPU8)]
        jaxes = [JaxEngine(k=21)]
    for eng in ports + jaxes:
        with pytest.raises(ValueError, match=match):
            eng.resume_checkpoint_into(ckpt)


SINGLE_READER = """
from kmer_tpu_torch.pipeline.yak import MeshSortYakEngine

eng = multihost.MultihostSortEngine(k=21, block_bases=65536)
eng.count_paths(args)
h = eng.hist(256, max_count=1023)
lines = []
yk = MeshSortYakEngine(k=21, pre=10, bf_shift=18, bf_n_hash=4,
                       chunk_size=65536,
                       log=lambda ns, tot: lines.append([ns, tot]))
yk.count(args, create_new=True)
result.update(hist=h.tolist(), nd=int(eng._n_distinct),
              tb=eng.total_bases, ts=eng.total_seqs, yak=lines)
"""


def test_single_reader_matches_one_process_mesh(tmp_path, files,
                                                monkeypatch):
    """KMER_TPU_SINGLE_READER=1 on two processes: hist and totals ==
    JAX's 1-process 8-device MultihostSortEngine, and the yak pass-1
    `[M` sequence (n_seqs, running total) == JAX's 1-process 8-device
    MeshSortYakEngine: the same batches, the same admission order."""
    got = run_workers(tmp_path, SINGLE_READER, files,
                      env={"KMER_TPU_SINGLE_READER": "1"}, name="sr")

    from kmer_tpu.dist.multihost import MultihostSortEngine
    from kmer_tpu.pipeline.yak import MeshSortYakEngine

    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "1")
    eng = MultihostSortEngine(k=21, block_bases=65536)
    eng.count_paths(files)
    want = np.asarray(eng.hist(256, max_count=1023))
    lines = []
    yk = MeshSortYakEngine(k=21, pre=10, bf_shift=18, bf_n_hash=4,
                           chunk_size=65536,
                           log=lambda ns, tot: lines.append([ns, tot]))
    yk.count(files, create_new=True)
    assert len(lines) == 3
    for g in got:
        assert np.array_equal(np.asarray(g["hist"]), want)
        assert (g["nd"], g["tb"], g["ts"]) == (
            eng._n_distinct, eng.total_bases, eng.total_seqs)
        assert g["yak"] == lines
