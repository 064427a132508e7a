"""The port's host-only tools (kc-py1, kc-cpp1, kc-cpp2, vcf-vaf-counter,
bam-vaf-counter) and the readers and decoders they run on
(kmer_tpu_torch.io.bgzf, vcf, bam, cram, cram31, cram_arith and the
native bam_count / cram_rans) against the JAX package's on the CPU.

Each tool must give the JAX tool's stdout, stderr, output file and exit
code byte for byte; each decoder the same bytes, or the same exception
type and message.  Inputs are the fixtures, or made with numpy and
random from a seed."""

import gzip
import importlib
import io
import os
import random
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
BED = os.path.join(FIXTURES, "snps_small.bed")
BAM = os.path.join(FIXTURES, "sampleA_aln.bam")
PKGS = ("kmer_tpu", "kmer_tpu_torch")


def _tool(pkg, name, args, stdin=None):
    """(exit code, stdout, stderr) of one in-process tool run; a
    SystemExit counts as the exit code."""
    fn = importlib.import_module(f"{pkg}.tools").get_tool(name)
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin, sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    if stdin is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        rc = fn(args)
    except SystemExit as e:
        rc = e.code
    finally:
        sys.stdin, sys.stdout, sys.stderr = old
    return rc, out.getvalue(), err.getvalue()


def _both(name, args, stdin=None):
    """Run a tool in JAX, then in the port; both results must be equal.
    Returns the port's (exit code, stdout, stderr)."""
    want = _tool("kmer_tpu", name, args, stdin)
    got = _tool("kmer_tpu_torch", name, args, stdin)
    assert got == want
    return got


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_registry_matches_jax():
    from kmer_tpu import tools as jtools
    from kmer_tpu_torch import tools

    assert tools.tool_names() == jtools.tool_names()
    assert len(tools.tool_names()) == 15


# -- kc-py1, kc-cpp1, kc-cpp2 ----------------------------------------------

def _dirty_fasta(seed):
    """Records with lowercase bases, N/n, IUPAC and odd characters, CRLF,
    an empty record and FASTQ-as-FASTA lines; no trailing newline."""
    rng = random.Random(seed)
    alphabet = "ACGTACGTACGTacgtNnRY-*. \r"
    recs = []
    for i in range(40):
        body = "".join(rng.choice(alphabet) for _ in range(rng.randint(
            40, 200)))
        lines = [body[j:j + 60] for j in range(0, len(body), 60)]
        recs.append(f">r{i} desc\n" + "\n".join(lines))
    recs.insert(7, ">empty")
    recs.append("@fq\n" + "ACGT" * 10 + "\n+\n" + "I" * 40)
    return "\n".join(recs).encode("latin-1")


@pytest.fixture(scope="module")
def raw_inputs(tmp_path_factory):
    """name -> bytes: the reads fixture (FASTQ read as line-FASTA) and
    the genome (FASTA), decompressed, and seeded dirty input."""
    out = {}
    for name, path in (("reads", READS), ("genome", GENOME)):
        with gzip.open(path, "rb") as f:
            out[name] = f.read()
    out["dirty"] = _dirty_fasta(5)
    return out


@pytest.mark.parametrize("which", ["reads", "genome", "dirty"])
def test_kc_py1_matches_jax(which, raw_inputs):
    rc, out, _ = _both("kc-py1", [], stdin=raw_inputs[which])
    assert rc == 0 and len(out.splitlines()) == 255


@pytest.mark.parametrize("k", [5, 31])
@pytest.mark.parametrize("which", ["reads", "genome", "dirty", "gzip"])
@pytest.mark.parametrize("tool", ["kc-cpp1", "kc-cpp2"])
def test_kc_cpp_matches_jax(tool, which, k, raw_inputs, tmp_path):
    """The text files, and a gzipped FASTA read as raw bytes (the C++
    originals have no gzip reader)."""
    if which == "gzip":
        path = GENOME
    else:
        path = str(tmp_path / "in.fa")
        with open(path, "wb") as f:
            f.write(raw_inputs[which])
    rc, out, _ = _both(tool, [f"-k{k}", path])
    assert rc == 0 and len(out.splitlines()) == 255


@pytest.mark.parametrize("args", [[], ["-k-1", GENOME], ["-k0", GENOME],
                                  ["/nonexistent.fa"], ["-k400", GENOME]])
@pytest.mark.parametrize("tool", ["kc-cpp1", "kc-cpp2"])
def test_kc_cpp_errors_match_jax(tool, args):
    _both(tool, args)


# -- vcf-vaf-counter ---------------------------------------------------------

@pytest.fixture(scope="module")
def patterns(tmp_path_factory):
    """The fixture panel (snp-pattern-gen -k21 on the genome and BED
    fixtures), written by the JAX package's tool."""
    out = str(tmp_path_factory.mktemp("pat") / "patterns.txt")
    rc, _, err = _tool("kmer_tpu", "snp-pattern-gen",
                       ["-k21", "-b", BED, "-f", GENOME, "-o", out])
    assert rc == 0, err
    return out


def _vaf_both(name, args_of, tmp_path):
    """Run a VAF tool in both packages, each writing its own file; the
    exit codes, stdout, stderr and files must be equal.  Returns the
    port's file (None when it wrote none)."""
    res = {}
    for pkg in PKGS:
        vaf = str(tmp_path / f"{pkg}.vaf")
        rc, out, err = _tool(pkg, name, args_of(vaf))
        res[pkg] = (rc, out, err.replace(vaf, "OUT"),
                    _read(vaf) if os.path.exists(vaf) else None)
    assert res["kmer_tpu_torch"] == res["kmer_tpu"]
    return res["kmer_tpu_torch"]


@pytest.mark.parametrize("ext", ["vcf", "vcf.gz", "bcf"])
def test_vcf_vaf_counter_matches_jax(ext, patterns, tmp_path):
    vcf = os.path.join(FIXTURES, f"sampleA.{ext}")
    rc, _, _, vaf = _vaf_both(
        "vcf-vaf-counter", lambda o: ["-p", patterns, "-v", vcf, "-o", o],
        tmp_path)
    assert rc == 0 and vaf.startswith(b"# Average depth:")
    assert any(ln.split(b"\t")[-1] != b"0.0000"
               for ln in vaf.splitlines()[1:])


@pytest.mark.parametrize("case", ["usage", "no_vcf", "no_patterns",
                                  "sample_1", "min_depth_30"])
def test_vcf_vaf_counter_errors_match_jax(case, patterns, tmp_path):
    vcf = os.path.join(FIXTURES, "sampleA.vcf")
    args = {"usage": lambda o: ["-p", patterns, "-o", o],
            "no_vcf": lambda o: ["-p", patterns, "-v", "/nonexistent.vcf",
                                 "-o", o],
            "no_patterns": lambda o: ["-p", "/nonexistent.txt", "-v", vcf,
                                      "-o", o],
            "sample_1": lambda o: ["-p", patterns, "-v", vcf, "-s1", "-o",
                                   o],
            "min_depth_30": lambda o: ["-p", patterns, "-v", vcf, "-d30",
                                       "-o", o]}[case]
    _vaf_both("vcf-vaf-counter", args, tmp_path)


# -- bam-vaf-counter ---------------------------------------------------------

def _sam():
    """The SAM text fixture is generated, not committed: make it as the
    JAX suite does (scripts/make_fixtures.py into a scratch directory,
    then copy the .sam over)."""
    sam = os.path.join(FIXTURES, "sampleA_aln.sam")
    if not os.path.exists(sam):
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            r = subprocess.run(
                [sys.executable,
                 os.path.join(REPO, "scripts", "make_fixtures.py"), td],
                capture_output=True)
            assert r.returncode == 0, r.stderr.decode()
            shutil.copy(os.path.join(td, "sampleA_aln.sam"), sam)
    return sam


@pytest.fixture
def native_bam_calls(monkeypatch):
    """The results of the port's bam_count_native calls."""
    from kmer_tpu_torch.io import native

    calls, real = [], native.bam_count_native

    def counted(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(native, "bam_count_native", counted)
    return calls


@pytest.mark.parametrize("case", ["bai", "unindexed", "unindexed_python",
                                  "csi", "sam"])
def test_bam_vaf_counter_matches_jax(case, patterns, tmp_path, monkeypatch,
                                     native_bam_calls):
    """The fixture BAM with its .bai (region queries), an unindexed copy
    (the sequential scan: native, and the Python reader under
    KMER_TPU_NO_NATIVE=1), a sorted BAM with only a CSI index written by
    the JAX package's writer, and the SAM text fixture."""
    from kmer_tpu.io.bamwrite import sam_to_bam, write_csi
    from kmer_tpu_torch.io import native

    if case == "bai":
        path = BAM
    elif case in ("unindexed", "unindexed_python"):
        path = str(tmp_path / "noidx.bam")
        shutil.copy(BAM, path)
        if case == "unindexed_python":
            monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    elif case == "csi":
        path = str(tmp_path / "sorted.bam")
        sam_to_bam(_sam(), path, sort=True)
        write_csi(path, path + ".csi")
    else:
        path = _sam()
    rc, _, err, vaf = _vaf_both(
        "bam-vaf-counter", lambda o: ["-p", patterns, "-o", o, path],
        tmp_path)
    assert rc == 0 and vaf.startswith(b"# Average depth:")
    indexed = "Using indexed access" in err
    assert indexed == (case in ("bai", "csi"))
    if case == "unindexed" and native.available():
        assert native_bam_calls and native_bam_calls[0] is not None
    else:
        assert all(c is None for c in native_bam_calls)
    if case in ("unindexed", "unindexed_python"):
        # the native scan and the Python reader write the same file
        shutil.copy(BAM, str(tmp_path / "noidx2.bam"))
        other = "0" if case == "unindexed_python" else "1"
        if other == "1":
            monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("KMER_TPU_NO_NATIVE")
        vaf2 = str(tmp_path / "other.vaf")
        assert _tool("kmer_tpu_torch", "bam-vaf-counter",
                     ["-p", patterns, "-o", vaf2,
                      str(tmp_path / "noidx2.bam")])[0] == 0
        assert _read(vaf2) == vaf


@pytest.mark.parametrize("case", ["usage", "no_bam", "no_patterns",
                                  "second_missing", "not_bam"])
def test_bam_vaf_counter_errors_match_jax(case, patterns, tmp_path):
    junk = str(tmp_path / "junk.bam")
    with open(junk, "wb") as f:
        f.write(b"not a bam file at all\n")
    args = {"usage": lambda o: ["-p", patterns, BAM],
            "no_bam": lambda o: ["-p", patterns, "-o", o, "/nonexistent.bam"],
            "no_patterns": lambda o: ["-p", "/nonexistent.txt", "-o", o,
                                      BAM],
            "second_missing": lambda o: ["-p", patterns, "-o", o, _sam(),
                                         "/nonexistent.bam"],
            "not_bam": lambda o: ["-p", patterns, "-o", o, junk]}[case]
    _vaf_both("bam-vaf-counter", args, tmp_path)


# -- the CRAM decoders -------------------------------------------------------

def _decode(fn, blob, size):
    """fn's output, or its exception's type name and message."""
    try:
        return fn(blob, size)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def _blobs(seed, n, lo=1, hi=64, prefix=b""):
    rng = random.Random(seed)
    return [prefix + bytes(rng.randint(0, 255)
                           for _ in range(rng.randint(lo, hi)))
            for _ in range(n)]


def _rans_streams():
    """Valid streams from chip_smoke.py's encoder (so its on-card check
    of the native decoder is rehearsed here too), and corrupt ones."""
    from chip_smoke import rans4x8_o0_encode

    rng = np.random.default_rng(9)
    valid = []
    for n in (1, 7, 4096, 10_001):
        p = rng.dirichlet(np.ones(6))
        data = bytes(rng.choice(np.frombuffer(b"ACGTN\0", np.uint8), n,
                                p=p))
        valid.append((rans4x8_o0_encode(data), data))
    corrupt = [(bytes([0]) + (100).to_bytes(4, "little") * 2
                + bytes([65, 200]), 100)]  # a freq walk cut short
    corrupt += [(b, 33) for b in _blobs(21, 40)]
    corrupt += [(bytes([o]) + b, 50) for o in (0, 1)
                for b in _blobs(22, 10, 8, 80)]
    return valid, corrupt


@pytest.mark.parametrize("no_native", [False, True],
                         ids=["native", "python"])
def test_rans_decode_matches_jax(no_native, monkeypatch):
    """rans_decode (io/cram.py) on valid streams (which must give back
    their input) and on the JAX suite's truncated block and seeded
    random bytes, through the native decoder and the Python one."""
    if no_native:
        monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    from kmer_tpu.io import cram as jcram
    from kmer_tpu_torch.io import cram, native

    valid, corrupt = _rans_streams()
    for blob, data in valid:
        n = len(data)
        got = cram.rans_decode(blob, n)
        assert got == data == jcram.rans_decode(blob, n)
        assert cram._rans_decode_py(blob, n) == data
        if native.available():
            assert native.rans_decode_native(blob, n) == data
    for blob, n in corrupt:
        assert _decode(cram.rans_decode, blob, n) == \
            _decode(jcram.rans_decode, blob, n)


def _codec_cases():
    """The JAX suite's handmade corrupt streams for each CRAM 3.1 codec,
    and seeded random ones (tests/test_cram31_codecs.py)."""
    nx16 = [b"", bytes([0x00]), bytes([0x01, 0x05]),
            bytes([0x08, 0x05, 0x00]), bytes([0x80, 0x05, 0x04]) + b"AB",
            bytes([0x40, 0x05, 0x81])]
    tok3 = [b"", struct.pack("<II", 10, 2) + b"\x01\x80\x00"]
    tok3 += _blobs(11, 40, 1, 48, prefix=struct.pack("<II", 64, 4) + b"\x00")
    return {"rans_nx16_decode": ([(b, 5) for b in nx16]
                                 + [(b, 33) for b in _blobs(7, 60)]),
            "tok3_decode_names": [(b, None) for b in tok3],
            "arith_decode": [(b"", 33)] + [(b, 33) for b in _blobs(17, 60)],
            "fqz_decode": [(b"", None)] + [(b, None)
                                           for b in _blobs(18, 60)]}


@pytest.mark.parametrize("fn", ["rans_nx16_decode", "tok3_decode_names",
                                "arith_decode", "fqz_decode"])
def test_cram31_decoders_match_jax(fn):
    mod = "cram31" if fn in ("rans_nx16_decode", "tok3_decode_names") \
        else "cram_arith"
    jfn = getattr(importlib.import_module(f"kmer_tpu.io.{mod}"), fn)
    tfn = getattr(importlib.import_module(f"kmer_tpu_torch.io.{mod}"), fn)
    cases = _codec_cases()[fn]
    outs = [_decode(tfn, b, n) for b, n in cases]
    assert outs == [_decode(jfn, b, n) for b, n in cases]
    assert any(isinstance(o, tuple) and o[0] == "ValueError" for o in outs)


def _code(path):
    """The module's syntax tree with every docstring taken out."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("mod", ["io/bgzf", "io/vcf", "io/bam", "io/cram",
                                 "io/cram31", "io/cram_arith",
                                 "tools/vcf_vaf_counter",
                                 "tools/bam_vaf_counter"])
def test_copies_match_jax(mod):
    """Each copied module is its original's code; only docstrings (the
    header naming the original) differ."""
    assert _code(os.path.join(REPO, "kmer_tpu_torch", f"{mod}.py")) == \
        _code(os.path.join(REPO, "kmer_tpu", f"{mod}.py"))
