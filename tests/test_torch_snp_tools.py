"""The SNP-fingerprint pipeline of the port (kmer_tpu_torch.tools:
snp-pattern-gen -> vaf-counter -> correlation-matrix -> match-classifier)
against the JAX package's tools on the fixtures, chained as
tests/test_golden_snp_pipeline.py chains them, on the CPU: every file
byte-identical, stderr identical once the decimals on timing lines are
masked, stream-sorted accumulation off and on.  Also the host modules the
slice copies (io/formats.py, utils/seq.py, utils/cli.py `c_atof`) against
their originals, the error paths, and the no-jax-import pin."""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BED = os.path.join(FIXTURES, "snps_small.bed")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
SAMPLES = ["sampleA1", "sampleA2", "sampleB"]
FQ = [os.path.join(FIXTURES, f"{s}.fq.gz") for s in SAMPLES]
VAFS = [f"{s}.vaf" for s in SAMPLES]

# (tool, args) in order; files are written in the working directory, so
# both packages print the same names
CHAIN = [
    ("snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", "p.pat"]),
    *[("vaf-counter", ["-k21", "-v", "-p", "p.pat", "-o", v, fq])
      for v, fq in zip(VAFS, FQ)],
    ("correlation-matrix", ["-o", "s.corr", "-t", *VAFS]),
    ("correlation-matrix", ["-o", "matched.corr", "-M", "matched", *VAFS]),
    ("correlation-matrix", ["-o", "strict.corr", "-M", "strict", *VAFS]),
    ("correlation-matrix", ["-o", "m5d2.corr", "-m5", "-d2", *VAFS]),
    ("match-classifier", ["-c", "s.corr", "-o", "t.match", "-v"]),
    ("match-classifier", ["-c", "s.corr", "-o", "p.match", "-v", "-P",
                          *VAFS]),
    ("match-classifier", ["-c", "s.corr", "-o", "pairs.match", "-v", "-T",
                          "known.pairs"]),
    ("match-classifier", ["-c", "s.corr", "-o", "fam.match", "-v", "-P",
                          "-F", *VAFS]),
]

_TIMING = re.compile(r"\d+\.\d+")


def masked(err):
    """stderr with the decimals of timing lines masked (the integer
    counts on them stay compared)."""
    return "\n".join(_TIMING.sub("#", ln) if "sec" in ln else ln
                     for ln in err.splitlines())


def _tool(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.tools").get_tool(name)


def run_chain(pkg, d, chain, monkeypatch):
    """Run chain in directory d; (exit codes, masked stderr, files)."""
    os.makedirs(d, exist_ok=True)
    monkeypatch.chdir(d)
    with open("known.pairs", "w") as f:
        f.write(f"{SAMPLES[0]}\t{SAMPLES[1]}\n")
    rcs, errs = [], []
    for name, args in chain:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rcs.append(_tool(pkg, name)(list(args)))
        assert out.getvalue() == ""
        errs.append(masked(err.getvalue()))
    files = {}
    for fn in sorted(os.listdir(d)):
        with open(fn, "rb") as f:
            files[fn] = f.read()
    return rcs, errs, files


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    """The JAX tools' chain on the fixtures, run once (the oracle)."""
    with pytest.MonkeyPatch.context() as mp:
        return run_chain("kmer_tpu", str(tmp_path_factory.mktemp("jax")),
                         CHAIN, mp)


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_snp_chain_matches_jax(chunk, jax_chain, tmp_path,
                               monkeypatch):
    """Every file of the chain byte-identical to the JAX tools', every
    exit code 0, every stderr equal after masking; the classifier finds
    the replicate pair.  The stream ladder runs at its default chunk and
    at a small one, so that it merges runs."""
    from kmer_tpu_torch.table import compactor

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    if chunk == "small":
        monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 16)
    rcs, errs, files = run_chain("kmer_tpu_torch", str(tmp_path / "port"),
                                 CHAIN, monkeypatch)
    want_rcs, want_errs, want_files = jax_chain
    assert rcs == want_rcs == [0] * len(CHAIN)
    assert sorted(files) == sorted(want_files)
    for fn in files:
        assert files[fn] == want_files[fn], fn
    for (name, args), got, want in zip(CHAIN, errs, want_errs):
        assert got == want, (name, args)
    assert files["p.pat"].count(b"\n") > 300
    assert b"Device:                cpu" in errs[1].encode()
    assert b"Warning: 9 k-mer collisions" in errs[1].encode()
    match = files["p.match"].decode()
    assert f"{SAMPLES[0]}\t{SAMPLES[1]}\t" in match and "\tMATCHED" in match


@pytest.mark.parametrize("native", ["native", "python"])
def test_vaf_counter_files_and_missing_file(native, tmp_path, monkeypatch,
                                            jax_chain):
    """vaf-counter over several files with an unopenable one between
    them: the file is skipped silently and the others still count, with
    the native reader and with the pure-Python one."""
    if native == "python":
        monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    pat = str(tmp_path / "p.pat")
    with open(pat, "wb") as f:
        f.write(jax_chain[2]["p.pat"])
    chain = [("vaf-counter", ["-v", "-p", pat, "-o", "multi.vaf", FQ[0],
                              str(tmp_path / "missing.fq.gz"), FQ[2]])]
    want = run_chain("kmer_tpu", str(tmp_path / "jax"), chain, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = run_chain("kmer_tpu_torch", str(tmp_path / "port"), chain,
                    monkeypatch)
    assert got == want and got[0] == [0]
    assert "missing.fq.gz" in got[1][0]
    assert "Sequences processed:   12000" in got[1][0]


@pytest.mark.parametrize("fault", ["unloadable", "unwritable"])
def test_vaf_counter_kernel_library_failure_is_loud(fault, tmp_path,
                                                    monkeypatch, jax_chain):
    """A kernel library that cannot load (or be built) while vaf-counter
    counts a file raises RuntimeError out of the tool: it is not taken
    for an unopenable input and skipped, and no VAF file is written.
    The extraction wrappers are made to load the library at first call,
    as they do on the card."""
    from kmer_tpu_torch.kernels import _build, extract
    from kmer_tpu_torch.tools import vaf_counter

    if fault == "unloadable":
        so = tmp_path / "libbroken.so"
        so.write_bytes(b"not a shared object")
        monkeypatch.setattr(_build, "_library_path", lambda: str(so))
    else:
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(_build, "BUILD_DIR",
                            str(tmp_path / "file" / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    for name in ("extract_keys", "extract_keys_rows"):
        def loading(*a, _fn=getattr(extract, name), **kw):
            _build.library()
            return _fn(*a, **kw)

        monkeypatch.setattr(extract, name, loading)
    pat, vaf = tmp_path / "p.pat", tmp_path / "a.vaf"
    pat.write_bytes(jax_chain[2]["p.pat"])
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="kernel library") as e:
        vaf_counter.main(["-p", str(pat), "-o", str(vaf), FQ[0]])
    assert isinstance(e.value.__cause__, OSError)
    assert not vaf.exists()


@pytest.mark.parametrize("stream", ["0", "1"])
def test_k15_one_plane_chain(stream, tmp_path, monkeypatch):
    """snp-pattern-gen -k15 and vaf-counter -k15: the one-plane compactor
    (an int32 ladder) answers counts_for, against the JAX tools in the
    mode `stream` names."""
    from kmer_tpu_torch.table import compactor

    chain = [
        ("snp-pattern-gen", ["-k15", "-b", BED, "-f", GENOME, "-o",
                             "k15.pat"]),
        ("vaf-counter", ["-k15", "-p", "k15.pat", "-o", "k15.vaf", FQ[0]]),
    ]
    monkeypatch.setenv("KMER_TPU_STREAM_SORT", stream)
    want = run_chain("kmer_tpu", str(tmp_path / "jax"), chain, monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 16)
    engines = []
    real = compactor.KmerCompactor.counts_for

    def counts_for(self, *a):
        engines.append(self.one_plane)
        return real(self, *a)

    monkeypatch.setattr(compactor.KmerCompactor, "counts_for", counts_for)
    got = run_chain("kmer_tpu_torch", str(tmp_path / "port"), chain,
                    monkeypatch)
    assert got == want and got[0] == [0, 0]
    assert engines == [True] * 2
    assert got[2]["k15.vaf"].count(b"\n") > 100


_BED_MISSING_CHR = ("chr1\t1000\t1001\trs1\tA\tC\n"
                    "chrNope\t10\t11\trs2\tG\tT\n"
                    "chr1\t5\t6\trs3\tA\tG\n")

ERRORS = [
    ("snp-pattern-gen", []),
    ("snp-pattern-gen", ["-k20", "-b", BED, "-f", GENOME, "-o", "x"]),
    ("snp-pattern-gen", ["-k33", "-b", BED, "-f", GENOME, "-o", "x"]),
    ("snp-pattern-gen", ["-b", BED, "-f", GENOME]),
    ("snp-pattern-gen", ["-b", BED, "-f", "/nonexistent.fa", "-o", "x"]),
    ("snp-pattern-gen", ["-b", "/nonexistent.bed", "-f", GENOME, "-o", "x"]),
    ("snp-pattern-gen", ["-k21", "-b", "odd.bed", "-f", GENOME, "-o",
                         "odd.pat"]),
    ("vaf-counter", []),
    ("vaf-counter", ["-o", "x.vaf", FQ[0]]),
    ("vaf-counter", ["-p", "p.pat", FQ[0]]),
    ("vaf-counter", ["-p", "p.pat", "-o", "x.vaf"]),
    ("vaf-counter", ["-k33", "-p", "p.pat", "-o", "x.vaf", FQ[0]]),
    ("vaf-counter", ["-k0", "-p", "p.pat", "-o", "x.vaf", FQ[0]]),
    ("vaf-counter", ["-p", "/nonexistent.pat", "-o", "x.vaf", FQ[0]]),
    ("correlation-matrix", []),
    ("correlation-matrix", ["-o", "x.corr"]),
    ("correlation-matrix", ["-o", "x.corr", "/nonexistent.vaf"]),
    ("match-classifier", []),
    ("match-classifier", ["-c", "/nonexistent.corr", "-o", "x"]),
]


@pytest.mark.parametrize("tool,args", ERRORS,
                         ids=[f"{t}:{' '.join(a)[:40]}" for t, a in ERRORS])
def test_errors_match_jax(tool, args, tmp_path, monkeypatch):
    """Usage and error text, exit codes, and the `chromosome ... not
    found` warning are identical."""
    def setup(d):
        os.makedirs(d)
        with open(os.path.join(d, "odd.bed"), "w") as f:
            f.write(_BED_MISSING_CHR)
        return d

    want = run_chain("kmer_tpu", setup(str(tmp_path / "jax")),
                     [(tool, args)], monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = run_chain("kmer_tpu_torch", setup(str(tmp_path / "port")),
                    [(tool, args)], monkeypatch)
    assert got == want
    if "odd.bed" in args:
        assert got[0] == [0]
        assert "Warning: chromosome chrNope not found" in got[1][0]
    else:
        assert got[0] == [1] or tool == "correlation-matrix"


# -- the copied host modules ---------------------------------------------


def test_c_atof_matches_original():
    from kmer_tpu.utils.cli import c_atof as want
    from kmer_tpu_torch.utils.cli import c_atof

    for s in ["0.5", " -2.5e-3x", "1e5", "1e", "3.5.2", "", "abc", "+.5",
              "inf", "-Infinity", "nan", "-nan", "0x1p3", "0x1.8p-1zz",
              "7", "-0", "1e+", ".", "5.", "1E308", "1e999"]:
        assert repr(c_atof(s)) == repr(want(s)), s


def test_seq_matches_original():
    from kmer_tpu.kernels.encode import SEQ_NT4_NP as nt4
    from kmer_tpu.utils import seq as J
    from kmer_tpu_torch.utils import seq as T

    assert np.array_equal(T.SEQ_NT4_NP, nt4)
    rng = np.random.default_rng(1)
    for _ in range(300):
        k = int(rng.integers(1, 33))
        s = bytes(rng.choice(list(b"ACGTNacgtu"), int(rng.integers(0, 40))))
        assert T.encode_kmer(s, k) == J.encode_kmer(s, k)
        x = int(rng.integers(0, 1 << (2 * k), dtype=np.uint64))
        assert T.revcomp_kmer(x, k) == J.revcomp_kmer(x, k)
        assert T.canonical_kmer(x, k) == J.canonical_kmer(x, k)
    keys = rng.integers(0, 1 << 64, 4096, dtype=np.uint64, endpoint=False)
    for k in (1, 15, 21, 31, 32):
        mask = (1 << (2 * k)) - 1
        assert np.array_equal(T.hash64_np(keys & np.uint64(mask), mask),
                              J.hash64_np(keys & np.uint64(mask), mask))


def test_formats_match_original(jax_chain, tmp_path):
    """Every reader and writer of the copy on the chain's files (and on
    a truncated, a ragged and a short VAF) against the original's."""
    from kmer_tpu.io import formats as J
    from kmer_tpu_torch.io import formats as T

    files = jax_chain[2]
    for fn, data in files.items():
        with open(tmp_path / fn, "wb") as f:
            f.write(data)
    d = str(tmp_path)
    with open(tmp_path / "odd.bed", "w") as f:
        f.write(_BED_MISSING_CHR + "chr2 7 x\n")
    for bed in (BED, f"{d}/odd.bed"):
        assert T.read_bed_snps(bed) == [T.Snp(**vars(s))
                                        for s in J.read_bed_snps(bed)]
    pats = T.read_patterns(f"{d}/p.pat")
    assert pats == [T.Pattern(**vars(p))
                    for p in J.read_patterns(f"{d}/p.pat")]
    with open(tmp_path / "ragged.vaf", "w") as f:
        f.write(files["sampleA1.vaf"].decode() + "chr9\t1\trs\tA\tC\t1\n"
                "chr9\t2\trs\tA\tC\t1\t1\t2\t0.5000\textra\n")
    with open(tmp_path / "short.vaf", "w") as f:
        f.write("# Average depth: 1.00\nCHR\tPOS\n")
    for v in (*VAFS, "ragged.vaf", "short.vaf"):
        got, want = T.read_vaf_file(f"{d}/{v}"), J.read_vaf_file(f"{d}/{v}")
        assert vars(got) == vars(want), v
        assert (T.read_vaf_avg_depth(f"{d}/{v}")
                == J.read_vaf_avg_depth(f"{d}/{v}"))
    assert T.read_vaf_file(f"{d}/{VAFS[0]}", max_snps=7).vaf == \
        J.read_vaf_file(f"{d}/{VAFS[0]}", max_snps=7).vaf
    assert T.read_corr_matrix(f"{d}/s.corr") == J.read_corr_matrix(
        f"{d}/s.corr")
    for p in pats:
        p.ref_count, p.alt_count = len(p.rsid), len(p.chr) % 3
    out = {}
    for mod in (T, J):
        with open(tmp_path / "rows.pat", "w") as f:
            for p in pats[:20]:
                mod.write_pattern_row(f, p, p.ref_kmer, p.alt_kmer)
        depth = mod.write_vaf_file(f"{d}/w.vaf", pats)
        names, m = mod.read_corr_matrix(f"{d}/s.corr")
        mod.write_corr_matrix(f"{d}/w.corr", names, m)
        out[mod] = [depth] + [open(f"{d}/{n}", "rb").read()
                              for n in ("rows.pat", "w.vaf", "w.corr")]
    assert out[T] == out[J]


# -- no jax, no kmer_tpu on the port's paths -------------------------------

_NO_JAX = """
import os, sys
sys.path.insert(0, {repo!r})
os.chdir({cwd!r})
from kmer_tpu_torch.tools import get_tool
for name, args in {chain!r}:
    assert get_tool(name)(args) == 0, (name, args)
assert os.path.getsize("p.match") > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "kmer_tpu"))
assert not bad, bad
"""


@pytest.mark.parametrize("native", ["native", "python"])
def test_snp_chain_never_imports_jax(native, tmp_path):
    """The four tools run in a fresh interpreter with neither jax nor
    any kmer_tpu module loaded, with the native reader and with the
    pure-Python one (KMER_TPU_NO_NATIVE)."""
    env = dict(os.environ, KMER_TPU_PLATFORM="cpu")
    if native == "python":
        env["KMER_TPU_NO_NATIVE"] = "1"
    with open(tmp_path / "known.pairs", "w") as f:
        f.write(f"{SAMPLES[0]}\t{SAMPLES[1]}\n")
    chain = [CHAIN[0], *CHAIN[1:4], CHAIN[4], CHAIN[9]]
    r = subprocess.run(
        [sys.executable, "-c",
         _NO_JAX.format(repo=REPO, cwd=str(tmp_path), chain=chain)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Found 1 matched pairs" in r.stderr
