"""The packed bloom beyond 2^31 bits, on the CPU: the plain reference
of any bloom size (h100bench/reference/yak_wide.py) against a
lane-by-lane loop of yak_bf_insert; the packed bits array's plain
test-and-set against a byte-a-bit loop; the probe indices at -b37
against the reference's; two-file yak-count given one two-member
FASTQ.gz under two names (the benchmark's `reads_twice` data) against
the reference, at -b22 and at -b32, past the 2^31 bits the other
engines clamp to; the data kind's two names and members, and the
cell's control; SortYakEngine's spans.

Every output is an integer: every comparison is exact."""

import gzip
import os
import re
import zlib

import numpy as np
import pytest
import torch

from h100bench import gen
from h100bench.data import reads_twice
from h100bench.reference import kmers, yak_wide
from h100bench.reference import yak as ref_yak
from kmer_tpu_torch.kernels import _build, bloom
from kmer_tpu_torch.kernels.keys import BIAS_I64, SENT, from_u64
from kmer_tpu_torch.tools import get_tool
from kmer_tpu_torch.utils import trace

K, PRE, N_HASH = 31, 10, 4

CFG = {"k": K, "genome": {"bases": 12_000, "gc": 0.41},
       "reads": {"count": 2_400, "members": 2, "length": 150,
                 "format": "fastq", "substitution_rate": 0.005,
                 "n_rate": 0.001, "reverse_strand_share": 0.5},
       "gzip_level": 1}
CHUNK = 30_000  # 200 reads a batch: 12 batches


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The data kind's files: one two-member FASTQ.gz and its second
    name, and the warm-up file likewise."""
    wd = str(tmp_path_factory.mktemp("reads_twice"))
    return reads_twice.make(CFG, 2**33 + 5, wd, 150 * 500, "cpu")


def _lane_loop(reads, k, pre, bf_shift, n_hash, chunk):
    """yak-count's two passes over one read set, lane by lane in read
    order: pass 1 runs yak_bf_insert (yak-count.c:91-108; every probe
    tested, then set) on each k-mer not yet in the table and admits it
    when all n_hash probes were set; pass 2 counts every k-mer of the
    table; the shrink keeps counts of 2 and more.  The bits are a set
    of indices, so any -b costs nothing."""
    keys = kmers.reads_keys(reads, k, "cpu")
    h = ref_yak.hash64(keys, k).tolist()
    local = bf_shift - pre
    xs = local - 9
    bits, table, lines = set(), set(), []
    for n_reads, n_lanes in ref_yak.batches(reads, k, chunk, "cpu"):
        for x_full in h[:n_lanes]:
            if x_full in table:
                continue
            sub, x = x_full & ((1 << pre) - 1), x_full >> pre
            z = (x >> xs) & 511
            h2 = (x >> local) & 511
            if h2 & 31 == 0:
                h2 = (h2 + 1) & 511
            base = (sub << local) + ((x & ((1 << min(xs, 32)) - 1)) << 9)
            cnt = 0
            for _ in range(n_hash):
                cnt += base + z in bits
                bits.add(base + z)
                z = (z + h2) & 511
            if cnt == n_hash:
                table.add(x_full)
        h = h[n_lanes:]
        lines.append((n_reads, len(table)))
    counts = torch.unique(ref_yak.hash64(keys, k), return_counts=True)[1]
    keep = counts[counts >= 2]
    text = [f"[M] processed {n} sequences; {t} distinct k-mers in the "
            f"hash table\n" for n, t in lines]
    text += [f"[M] processed {n} sequences; {len(table)} distinct k-mers "
             f"in the hash table\n" for n, _ in lines]
    text.append(f"[M::main] {keep.shape[0]} distinct k-mers after "
                f"shrinking\n")
    return kmers.hist_rows(keep, ref_yak.N_BINS) + "".join(text)


@pytest.mark.parametrize("bf_shift", [19, 37])
def test_reference_matches_lane_loop(inputs, bf_shift):
    """yak_wide's admission (a stable sort of probe entries by bit, no
    bit << 32 | lane key) equals the lane-by-lane loop; at -b19 the
    small bloom admits false positives, at -b37 the bit indices pass
    2^32."""
    reads = inputs.files[0].reads
    want = _lane_loop(reads, K, PRE, bf_shift, N_HASH, CHUNK)
    got = yak_wide.expected(reads, K, PRE, bf_shift, N_HASH, CHUNK, "cpu")
    assert got == want
    m = re.findall(r"; (\d+) distinct", got)
    assert len(m) == 2 * 12 and int(m[0]) < int(m[11])
    if bf_shift == 19:  # false positives: more admitted than at -b37
        wide = yak_wide.expected(reads, K, PRE, 37, N_HASH, CHUNK, "cpu")
        assert int(re.findall(r"; (\d+) distinct", wide)[11]) < int(m[11])
        assert got.split("[M")[0] == wide.split("[M")[0]


def _byte_loop(flags, idxs, valid, sequential):
    """The byte-a-bit layout's test-and-set, lane by lane: sequential,
    each probe tested then set (a lane that probes one bit twice finds
    it set the second time); batched, tested against the bits before
    the call, then all set."""
    before = flags.copy()
    flags = flags.copy()
    preset = np.zeros(valid.shape[0], bool)
    for i in np.flatnonzero(valid):
        cnt = 0
        for ix in idxs:
            cnt += int((flags if sequential else before)[ix[i]])
            flags[ix[i]] = 1
        preset[i] = cnt == len(idxs)
    return flags, preset


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("pre,n_shift,n_hashes", [(0, 9, 40), (4, 14, 4),
                                                  (10, 22, 4)])
def test_packed_insert_matches_byte_layout(sequential, pre, n_shift,
                                           n_hashes):
    """insert_sequential and insert on the packed array (the plain
    version, as on the CPU; `admit` too) equal the byte-a-bit loop's
    verdicts and bits, unpacked, lane for lane over four blocks: repeats
    within and across blocks, sentinel and invalid lanes, and at -H40
    a key that probes one bit twice."""
    spec = bloom.BloomSpec(pre, n_shift, n_hashes)
    rng = np.random.default_rng(n_shift * 3 + sequential)
    pool = rng.integers(0, 1 << 62, 600, dtype=np.uint64)
    bits = bloom.make_bits(spec)
    adm_bits = bloom.make_bits(spec)
    flags = np.zeros(1 << n_shift, np.uint8)
    assert bits.shape[0] == 1 << (n_shift - 3)
    fn = bloom.insert_sequential if sequential else bloom.insert
    twice = False
    for _ in range(4):
        k = pool[rng.integers(0, pool.shape[0], 700)]
        k[rng.random(k.shape[0]) < 0.05] = np.uint64((1 << 64) - 1)
        tk = torch.from_numpy(from_u64(k))
        valid = (tk != SENT).numpy()
        valid[rng.random(k.shape[0]) < 0.03] = False
        idxs = [ix.numpy() for ix in bloom.probe_indices(tk, spec)]
        twice |= any((a == b).any() for j, a in enumerate(idxs)
                     for b in idxs[:j])
        flags, want = _byte_loop(flags, idxs, valid, sequential)
        out, got = fn(bits, tk, torch.from_numpy(valid), spec)
        assert out is bits
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(bloom.unpack_bits(bits).numpy(), flags)
        keys_in = torch.where(torch.from_numpy(valid), tk, SENT)
        admitted = bloom.admit(adm_bits, keys_in, spec, sequential)
        assert torch.equal(admitted, torch.where(got, tk, SENT))
        assert torch.equal(adm_bits, bits)
    assert twice == (n_hashes == 40)
    assert bloom.pack_bits(torch.from_numpy(flags)).equal(bits)


def test_probe_indices_at_b37_match_reference():
    """probe_indices of biased keys at -b37 (and -b38, -p25) equal the
    reference's probe_bits of the hashed keys: indices past 2^32."""
    rng = np.random.default_rng(37)
    h = torch.from_numpy(rng.integers(0, 1 << 62, 5000, dtype=np.int64))
    for pre, b in ((10, 37), (25, 38)):
        got = bloom.probe_indices(h ^ BIAS_I64, bloom.BloomSpec(pre, b, 4))
        want = ref_yak.probe_bits(h, pre, b, 4)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        assert int(torch.stack(got).max()) >= 1 << 33
        assert int(torch.stack(got).max()) < 1 << b


def test_bloom_entry_point_matches_its_signature():
    """csrc/bloom.cu's C entry point has as many parameters as its
    ctypes signature."""
    with open(os.path.join(_build.CSRC, "bloom.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ktt_bloom_insert\(([^)]*)\)', src)
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(_build._SIGNATURES["ktt_bloom_insert"])
    assert "bloom" in _build.LAUNCHES


def _yak(args, capsys):
    rc = get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("bf_shift", [22, 32])
def test_two_names_match_reference(inputs, bf_shift, capsys, monkeypatch):
    """yak-count -k31 -p10 -bB -H4 A A2 (A2 a second name of A, a
    two-member FASTQ.gz) runs the two-file engine with the bloom asked
    for, 2^32 bits (512 MiB packed) past the clamp included, without a
    warning: stdout and every `[M` line equal yak_wide's."""
    from kmer_tpu_torch.tools import yak_count

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    made, real = [], yak_count.make_yak_engine

    def record(**kw):
        made.append(real(**kw))
        return made[-1]

    monkeypatch.setattr(yak_count, "make_yak_engine", record)
    a, a2 = (f.path for f in inputs.files)
    rc, out, err = _yak([f"-k{K}", f"-p{PRE}", f"-b{bf_shift}",
                         f"-H{N_HASH}", f"-K{CHUNK}", a, a2], capsys)
    assert rc == 0 and "[W::" not in err
    eng = made[0]
    assert type(eng).__name__ == "SortYakEngine"
    assert eng.bf_shift == bf_shift
    got = out + "".join(ln + "\n" for ln in err.splitlines()
                        if ln.startswith("[M"))
    want = yak_wide.expected(inputs.files[0].reads, K, PRE, bf_shift,
                             N_HASH, CHUNK, "cpu")
    assert got == want


def test_reads_twice_two_names_and_members(inputs):
    """The data kind's two paths name one file (a hard link: the same
    bytes), which holds two gzip members, R1's reads then R2's, both
    read back; the warm-up file likewise."""
    for pair in (inputs.files, inputs.warmup):
        a, b = pair
        assert a.path != b.path and os.path.samefile(a.path, b.path)
        assert a.reads is b.reads
        with open(a.path, "rb") as f:
            raw = f.read()
        d = zlib.decompressobj(31)
        first = d.decompress(raw)
        assert d.eof and d.unused_data[:2] == b"\x1f\x8b"  # a 2nd member
        text = gzip.decompress(raw)
        assert text.startswith(first) and len(text) > len(first)
        n = a.reads.shape[0]
        assert text.count(b"\n@") + 1 == n
        seqs = np.frombuffer(b"".join(text.split(b"\n")[1::4]), np.uint8)
        want = gen.ACGTN[a.reads.reshape(-1)]
        assert np.array_equal(seqs, want)
        assert first.count(b"\n+\n") == n // 2


def test_cell_control_differs(inputs, monkeypatch):
    """The check of the benchmark cell (-b37) takes yak_wide's text at
    the cell's bloom; its control clamps the bloom (to 2^31 bits in the
    cell, where 150 M keys fill it enough for false positives; here to
    2^19, so this small input has them too), and its [M lines differ."""
    from h100bench import spec
    from h100bench.spec import load_module

    cell = spec.load_cell("yak_trio_b37")
    assert cell.traffic["params"]["bloom_bits"] == 37
    assert cell.config["k"] == K and cell.traffic["inputs_per_job"] == 2
    cell.traffic["params"]["chunk"] = CHUNK
    check = load_module("checks", cell.traffic["check"])
    want = check.expected(inputs, cell, [(0, 1)], "cpu")["jobs"][(0, 1)]
    assert want == yak_wide.expected(inputs.files[0].reads, K, PRE, 37,
                                     N_HASH, CHUNK, "cpu")
    monkeypatch.setattr(yak_wide, "CLAMP_SHIFT", 19)
    ctrl = check.expected(inputs, cell, [(0, 1)], "cpu", True)["jobs"][(0, 1)]
    assert ctrl != want and ctrl.split("[M")[0] == want.split("[M")[0]


def test_sort_yak_spans(inputs, capsys, monkeypatch):
    """SortYakEngine records, with the tracer on: one `yak.pass` a pass
    (`pass` 1 and 2, `bases` the file's), the count loop's span: the
    reader's `ingest.wait` and the `ingest.dispatch` spans of its blocks
    lie under it, as under SortCountEngine's `count.loop`; one
    `yak.bloom` a pass-1 block inside its dispatch span (`lanes`: its
    valid lanes, summing to the file's k-mer windows without N); and one
    `yak.shrink`."""
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    a, a2 = (f.path for f in inputs.files)
    trace.clear()
    trace.enable(True)
    try:
        rc, _, _ = _yak([f"-k{K}", "-b22", f"-K{CHUNK}", a, a2], capsys)
    finally:
        trace.enable(False)
    every = trace.spans()
    rec = [s for s in every if s.name.startswith("yak.")]
    trace.clear()
    assert rc == 0
    passes = [s for s in rec if s.name == "yak.pass"]
    assert [s.attrs["pass"] for s in passes] == [1, 2]
    assert all(s.attrs["bases"] == inputs.files[0].bases for s in passes)
    blooms = [s for s in rec if s.name == "yak.bloom"]
    assert len(blooms) == 12
    dispatch = {s.id: s.parent for s in every
                if s.name == "ingest.dispatch"}
    assert {dispatch[s.parent] for s in blooms} == {passes[0].id}
    assert set(dispatch.values()) == {p.id for p in passes}
    assert {s.parent for s in every if s.name == "ingest.wait"} == {
        p.id for p in passes}
    assert all(passes[0].t0 <= s.t0 and s.t1 <= passes[0].t1
               for s in blooms)
    lanes = sum(n for _, n in ref_yak.batches(inputs.files[0].reads, K,
                                              CHUNK, "cpu"))
    assert sum(int(s.attrs["lanes"]) for s in blooms) == lanes
    shrink = [s for s in rec if s.name == "yak.shrink"]
    assert len(shrink) == 1 and shrink[0].t0 >= passes[1].t1
    assert set(shrink[0].attrs) == set()


# enough of CUDA to run csrc/bloom.cu's kernels on the host: a launch runs
# HOST_THREADS threads of one grid-stride block at once, with the atomics
# as the compiler's atomic builtins
_HOST_CUDA = """
#pragma once
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
struct dim3 { unsigned x, y, z; };
inline thread_local dim3 blockIdx{0, 0, 0}, blockDim{1, 1, 1},
    gridDim{1, 1, 1}, threadIdx{0, 0, 0};
enum cudaError_t { cudaSuccess = 0 };
typedef struct CUstream_st* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1; return cudaSuccess; }
inline unsigned long long atomicCAS(unsigned long long* p,
                                    unsigned long long c,
                                    unsigned long long v) {
  __atomic_compare_exchange_n(p, &c, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return c; }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned o = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > o && !__atomic_compare_exchange_n(
      p, &o, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return o; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
template <class F> void host_launch(F f) {
  std::vector<std::thread> ts;
  unsigned ready = 0;  // the threads start the kernel together
  for (unsigned i = 0; i < HOST_THREADS; ++i)
    ts.emplace_back([&f, &ready, i] {
      threadIdx = {i, 0, 0};
      gridDim = {HOST_THREADS, 1, 1};
      __atomic_add_fetch(&ready, 1, __ATOMIC_SEQ_CST);
      while (__atomic_load_n(&ready, __ATOMIC_SEQ_CST) < HOST_THREADS) {}
      f();
    });
  for (auto& t : ts) t.join();
}
"""


@pytest.mark.parametrize("threads", [1, 8])
def test_bloom_kernel_logic_on_host(tmp_path, threads):
    """csrc/bloom.cu built with g++ against a stand-in for CUDA (each
    launch a grid-stride block of 1 or 8 host threads at once, the
    atomics the compiler's) equals the plain twin:
    `ktt_bloom_insert`'s verdicts, admitted keys and bits, sequential and
    batched, over four calls on one first-setter table (left dirty by
    each call, zeroed by the next), at -H40 and on a mesh shard's
    spec.  One thread checks the arithmetic; eight race for slots,
    first setters and words as the card's threads do (a tenth of each
    call's lanes is one hot key); the card checks the build, the launch
    and its own interleavings."""
    import ctypes
    import subprocess

    with open(os.path.join(_build.CSRC, "bloom.cu")) as f:
        src = re.sub(r"(\w+(?:<\w+>)?)<<<[^>]*>>>\((.*?)\);",
                     r"host_launch([&] { \1(\2); });", f.read(),
                     flags=re.S)
    assert src.count("host_launch(") == 4
    (tmp_path / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp_path / "bloom_host.cpp").write_text(src)
    so = str(tmp_path / "libbloom_host.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-DHOST_THREADS={threads}u", "-I", str(tmp_path), "-o",
                    so, str(tmp_path / "bloom_host.cpp")], check=True)
    fn = ctypes.CDLL(so).ktt_bloom_insert
    fn.argtypes = _build._SIGNATURES["ktt_bloom_insert"]
    rng = np.random.default_rng(40)
    for spec in (bloom.BloomSpec(0, 9, 40), bloom.BloomSpec(10, 24, 4),
                 bloom.BloomSpec(10, 22, 3, owner_bits=3)):
        for sequential in (True, False):
            twin, bits = bloom.make_bits(spec), bloom.make_bits(spec)
            size = 1 << 16
            tags = torch.full((size,), -1, dtype=torch.int64)
            ranks = torch.full((size,), -1, dtype=torch.int32)
            pool = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
            for call in range(1, 5):
                k = pool[rng.integers(0, pool.shape[0], 4000)]
                k[rng.random(k.shape[0]) < 0.1] = pool[call]
                k[rng.random(k.shape[0]) < 0.05] = np.uint64((1 << 64) - 1)
                keys = torch.from_numpy(from_u64(k))
                valid = keys != SENT
                valid[torch.from_numpy(rng.random(keys.shape[0]) < 0.02)] \
                    = False
                plain = (bloom.insert_sequential_plain if sequential
                         else bloom.insert_plain)
                want = plain(twin, keys, valid, spec)[1]
                admit = call % 2 == 0
                out = torch.empty(keys.shape[0], dtype=torch.int64 if admit
                                  else torch.bool)
                if admit:
                    keys = torch.where(valid, keys, SENT)
                assert fn(keys.data_ptr(), None if admit
                          else valid.data_ptr(), keys.shape[0], spec.pre,
                          spec.n_shift, spec.n_hashes, spec.owner_bits,
                          int(sequential), bits.data_ptr(), tags.data_ptr(),
                          ranks.data_ptr(), size - 1,
                          None if admit else out.data_ptr(),
                          out.data_ptr() if admit else None, None) == 0
                assert torch.equal(out, torch.where(want, keys, SENT)
                                   if admit else want)
                assert torch.equal(bits, twin)
            assert want.any() and not want.all()
