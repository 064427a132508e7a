"""Runs of several processes on the port (kmer_tpu_torch.dist.multihost
over torch.distributed) against the JAX package on the CPU: two real
port processes under gloo, four CPU shards each (a global mesh of
eight, through dist.sharded.default_devices), one torch thread each;
the JAX side runs in the test process, on its eight virtual CPU
devices, as tests/test_multiprocess.py runs it.  Each worker asserts,
after its run, that neither jax nor any module of kmer_tpu was loaded.
Every output is an integer or text, so every comparison is exact
(tolerance 0).

One two-process run executes count_multihost over three files (with
queries), kc-c4 at k = 21 and 15, two-file yak-count, snp-pattern-gen
and vaf-counter through the tools' main functions, in order, as one
process group; the tests below check its parts.  The checkpoint and
single-reader runs are in tests/test_torch_multiprocess_yak.py."""

import contextlib
import gzip
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")
B = os.path.join(FIXTURES, "sampleB.fq.gz")
BED = os.path.join(FIXTURES, "snps_small.bed")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
KC_ARGS = {21: ["-k21", "-b65536"], 15: ["-k15", "-b65536"]}
YAK_ARGS = ["-k21", "-b14", "-K65536"]

# every worker: the port on the CPU, four shards, one thread, then
# multihost.initialize with the rank, world size and port given
WORKER_HEAD = """
import contextlib, io, json, os, sys
sys.path.insert(0, {repo!r})
os.environ["KMER_TPU_PLATFORM"] = "cpu"
import numpy as np
import torch
torch.set_num_threads(1)
from kmer_tpu_torch.dist import multihost, sharded
sharded.default_devices = lambda: [torch.device("cpu")] * 4
pid, nproc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
args = sys.argv[5:]
multihost.initialize("127.0.0.1:" + port, nproc, pid)
result = {{}}


def captured(fn, *a):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*a)
    assert rc in (0, None), rc
    return out.getvalue(), err.getvalue()
""".format(repo=REPO)

WORKER_TAIL = """
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "kmer_tpu"))
assert not bad, bad
with open(os.path.join(out_dir, f"result{pid}.json"), "w") as f:
    json.dump(result, f)
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(tmp_path, body: str, args, n_proc=2, env=None, name="w"):
    """Start n_proc port workers running `body` (after WORKER_HEAD, with
    `args` as their argument list), each with a timeout and killed if it
    hangs; every exit code must be 0.  Returns each process's result
    dict."""
    out_dir = tmp_path / f"{name}_out"
    out_dir.mkdir(exist_ok=True)
    script = tmp_path / f"{name}.py"
    script.write_text(WORKER_HEAD + body + WORKER_TAIL)
    port = str(free_port())
    wenv = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_", "KMER_TPU_"))}
    wenv.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(n_proc), port,
         str(out_dir), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=wenv)
        for pid in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    results = []
    for pid in range(n_proc):
        with open(out_dir / f"result{pid}.json") as f:
            results.append(json.load(f))
    return results


def write_fastq(path, rng, n_reads, length):
    with gzip.open(path, "wb") as f:
        for r in range(n_reads):
            s = "".join(rng.choice(list("ACGT"), length))
            f.write(f"@r{r}\n{s}\n+\n{'I' * length}\n".encode())


def queries_of(paths, k=21, n=16):
    """n distinct present k-mer keys of the first file's first reads
    (the JAX package's extraction) and two absent keys, as uint64."""
    from kmer_tpu.io.fastx import FastxReader
    from kmer_tpu.pipeline.counter import _extract_step

    import jax.numpy as jnp

    reads = []
    for _n, sq in FastxReader(paths[0]):
        reads.append(sq)
        if len(reads) >= 3:
            break
    buf = np.frombuffer(b"\x00".join(reads) + b"\x00", np.uint8)
    ehi, elo, _nk = _extract_step(jnp.asarray(buf), k)
    keys = (np.asarray(ehi).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(elo).astype(np.uint64)
    uniq = np.unique(keys)
    uniq = uniq[uniq != np.uint64((1 << 64) - 1)][:n]
    return np.concatenate([uniq, np.asarray([12345, 67890], np.uint64)])


TWO_PROCS = """
from kmer_tpu_torch.tools import get_tool
from kmer_tpu_torch.utils.log import is_primary
import torch.distributed as dist

q = np.load(args[0])
qhi = (q >> np.uint64(32)).astype(np.uint32)
qlo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
h, nd, qc = multihost.count_multihost(args[1:4], k=21, block=65536,
                                      queries=(qhi, qlo))
result["count"] = {"hist": h.tolist(), "nd": int(nd), "qc": qc.tolist()}
for k in (21, 15):
    result[f"kc{k}"] = captured(get_tool("kc-c4"),
                                [f"-k{k}", "-b65536", args[4]])[0]
result["yak2"] = captured(get_tool("yak-count"),
                          ["-k21", "-b14", "-K65536", args[5], args[6]])[0]
d = os.path.join(out_dir, f"p{pid}")
os.makedirs(d)
captured(get_tool("snp-pattern-gen"), ["-k21", "-b", args[7], "-f",
                                       args[8], "-o", os.path.join(d, "p.pat")])
captured(get_tool("vaf-counter"), ["-k21", "-p", args[9], "-o",
                                   os.path.join(d, "a.vaf"), args[5]])
result["files"] = sorted(os.listdir(d))
result["primary"] = is_primary()
result["backend"] = dist.get_backend()
result["shard_files"] = multihost.shard_files(["a", "b", "c"])
"""


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    """The two-process run and the JAX package's answers to it."""
    from kmer_tpu.tools import get_tool

    tmp = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(5)
    paths = [str(tmp / f"mh{i}.fq.gz") for i in range(3)]
    for p in paths:
        write_fastq(p, rng, 300, 120)
    q = queries_of(paths)
    np.save(tmp / "q.npy", q)
    jdir = tmp / "jax"
    jdir.mkdir()
    pat = str(jdir / "p.pat")

    def jax_out(name, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert get_tool(name)(argv) in (0, None)
        return out.getvalue()

    jax_out("snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", pat])
    jax_out("vaf-counter", ["-k21", "-p", pat, "-o", str(jdir / "a.vaf"),
                            A1])
    got = run_workers(tmp, TWO_PROCS, [tmp / "q.npy", *paths, READS, A1, B,
                                       BED, GENOME, pat], name="two_procs")
    want = {f"kc{k}": jax_out("kc-c4", [*KC_ARGS[k], READS])
            for k in KC_ARGS}
    want["yak2"] = jax_out("yak-count", [*YAK_ARGS, A1, B])
    return {"got": got, "want": want, "paths": paths, "q": q,
            "jdir": jdir, "tmp": tmp}


def test_count_multihost_matches_single_engine(two_procs):
    """count_multihost over three files round-robin on two processes ==
    the JAX SortCountEngine: hist, distinct total and counts_for (two
    absent keys included), the same on both processes."""
    from kmer_tpu.pipeline.counter import SortCountEngine

    eng = SortCountEngine(k=21)
    eng.count_paths(two_procs["paths"])
    want = eng.hist(256, max_count=1023)
    q = two_procs["q"]
    want_qc = eng.counts_for((q >> np.uint64(32)).astype(np.uint32),
                             (q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    for got in two_procs["got"]:
        c = got["count"]
        assert c["nd"] == eng._n_distinct
        assert np.array_equal(np.asarray(c["hist"]), want.astype(np.int64))
        assert np.array_equal(np.asarray(c["qc"]), np.asarray(want_qc))
        assert sum(c["qc"][:-2]) > 0 and c["qc"][-2:] == [0, 0]


@pytest.mark.parametrize("k", sorted(KC_ARGS))
def test_kc_c4_primary_prints_jax_histogram(two_procs, k):
    """kc-c4 (two-plane keys at k = 21, one int32 plane at k = 15):
    process 0's stdout == the JAX main_kc_c4's, process 1 prints no
    row."""
    got = two_procs["got"]
    assert got[0][f"kc{k}"] == two_procs["want"][f"kc{k}"]
    assert got[0][f"kc{k}"].count("\n") == 255
    assert got[1][f"kc{k}"] == ""


def test_two_file_yak_count_matches_jax(two_procs):
    """Two-file yak-count (bloom admission per owner, the shrink join
    summed over processes): process 0's stdout == JAX's, process 1
    prints nothing."""
    got = two_procs["got"]
    assert got[0]["yak2"] == two_procs["want"]["yak2"]
    assert got[1]["yak2"] == ""


@pytest.mark.parametrize("name", ["p.pat", "a.vaf"])
def test_snp_tools_write_on_primary_only(two_procs, name):
    """snp-pattern-gen and vaf-counter: process 0's file == the JAX
    tool's byte for byte, and process 1 writes none."""
    got = two_procs["got"]
    assert got[0]["files"] == ["a.vaf", "p.pat"]
    assert got[1]["files"] == []
    with open(two_procs["tmp"] / "two_procs_out" / "p0" / name, "rb") as f:
        mine = f.read()
    with open(two_procs["jdir"] / name, "rb") as f:
        assert mine == f.read()
    assert mine.count(b"\n") > 100


@pytest.mark.parametrize("pid,primary,files", [
    (0, True, ["a", "c"]), (1, False, ["b"])])
def test_process_roles(two_procs, pid, primary, files):
    """is_primary is rank 0 alone; shard_files is round-robin; the CPU
    run takes gloo."""
    got = two_procs["got"][pid]
    assert got["primary"] is primary
    assert got["shard_files"] == files
    assert got["backend"] == "gloo"


@pytest.mark.parametrize("paths,pi,pc,want", [
    (["a", "b", "c", "d", "e"], 0, 2, ["a", "c", "e"]),
    (["a", "b", "c", "d", "e"], 1, 2, ["b", "d"]),
    (["a"], 1, 2, []),
    (["a", "b", "c"], 2, 4, ["c"]),
    (["a", "b"], 0, 1, ["a", "b"]),
])
def test_shard_files_round_robin(paths, pi, pc, want):
    """The JAX package's round-robin, for explicit ranks."""
    from kmer_tpu.dist.multihost import shard_files as jax_shard_files
    from kmer_tpu_torch.dist import multihost

    assert multihost.shard_files(paths, pi, pc) == want
    assert jax_shard_files(paths, pi, pc) == want


@pytest.mark.parametrize("device,procs,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 8, 4, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 4, "nccl")])
def test_backend_follows_topology(device, procs, cards, want):
    """NCCL only when each process of the host has a card of its own."""
    from kmer_tpu_torch.dist import multihost

    assert multihost.choose_backend(device, procs, cards) == want


def test_single_process_needs_no_init(monkeypatch):
    """One process: initialize returns without a process group, and the
    process is the primary one, with one process of index 0."""
    import torch.distributed as dist

    from kmer_tpu_torch.dist import multihost, sharded
    from kmer_tpu_torch.utils.log import is_primary

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not dist.is_initialized()
    assert is_primary()
    assert (sharded.process_index(), sharded.process_count()) == (0, 1)


@pytest.mark.parametrize("value,want", [
    ("1", True), ("on", True), ("Yes", True), ("0", False), ("", False)])
def test_single_reader_switch(monkeypatch, value, want):
    from kmer_tpu.dist.multihost import single_reader as jax_single_reader
    from kmer_tpu_torch.dist import multihost

    monkeypatch.setenv("KMER_TPU_SINGLE_READER", value)
    assert multihost.single_reader() is want is jax_single_reader()
