"""kc-c1..c4 of the port (kmer_tpu_torch.tools) against kmer_tpu.tools:
stdout must be byte-identical on both fixtures at k in {15, 21, 31, 32}
(yak-count is tests/test_torch_cli_yak.py).  Also pins that the port
never imports jax nor anything of kmer_tpu (it carries its own copies of
the host modules it shares with it)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")


def _run(pkg, tool, args, capsys):
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool(tool)(args)
    assert not rc
    return capsys.readouterr().out


@pytest.mark.parametrize("k", [15, 21, 31, 32])
@pytest.mark.parametrize("path", [READS, GENOME], ids=["reads", "genome"])
@pytest.mark.parametrize("tool", ["kc-c1", "kc-c2", "kc-c3", "kc-c4"])
def test_cli_matches_jax(tool, path, k, capsys, monkeypatch):
    want = _run("kmer_tpu", tool, [f"-k{k}", path], capsys)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _run("kmer_tpu_torch", tool, [f"-k{k}", path], capsys)
    assert len(want.splitlines()) == 255
    assert got == want


@pytest.mark.parametrize("args", [[], ["-k0", READS], ["-k33", READS],
                                  ["-p5", READS], ["/nonexistent.fa"]])
@pytest.mark.parametrize("tool", ["kc-c1", "kc-c2", "kc-c3", "kc-c4"])
def test_cli_errors_match_jax(tool, args, capsys, monkeypatch):
    """Usage and error text (stderr) and exit codes are identical."""
    from kmer_tpu.tools import get_tool as jax_tool
    from kmer_tpu_torch.tools import get_tool

    rc_want = jax_tool(tool)(args)
    want = capsys.readouterr()
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    rc = get_tool(tool)(args)
    got = capsys.readouterr()
    assert (rc, got.out, got.err) == (rc_want, want.out, want.err)


_NO_JAX = """
import sys
sys.path.insert(0, {repo!r})
{body}
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
bad = sorted(m for m in sys.modules
             if m == "kmer_tpu" or m.startswith("kmer_tpu."))
assert not bad, bad
"""


def _python(body, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(repo=REPO, body=body)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)


def test_port_cli_never_imports_jax(tmp_path):
    """kc-c4, yak-count (one file and two) and ed-vaf-counter run with
    neither jax nor any kmer_tpu module loaded."""
    pat = str(tmp_path / "p.pat")
    vaf = str(tmp_path / "s.vaf")
    with open(pat, "w") as f:
        f.write("chr1\t100\t101\trs1\tA\tC\tACGTACGTACGTACGTACGTA\t"
                "ACGTACGTACCTACGTACGTA\n")
    r = _python(
        "from kmer_tpu_torch.tools import get_tool\n"
        f"rc = get_tool('kc-c4')(['-k21', {READS!r}])\n"
        "assert rc == 0\n"
        f"rc = get_tool('yak-count')(['-b20', {READS!r}])\n"
        "assert rc == 0\n"
        f"rc = get_tool('yak-count')(['-b20', {READS!r}, {GENOME!r}])\n"
        "assert rc == 0\n"
        f"rc = get_tool('ed-vaf-counter')(['-e1', '-p', {pat!r}, '-o', "
        f"{vaf!r}, {READS!r}])\n"
        "assert rc == 0\n",
        {"KMER_TPU_PLATFORM": "cpu"})
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 255 + 2 * 1023
    assert r.stderr.count("distinct k-mers after shrinking") == 2
    assert "rs1" in open(vaf).read()


def test_table_yak_never_imports_jax():
    """KMER_TPU_TABLE_YAK=1 two-file yak-count (YakEngine, and
    MeshYakEngine under KMER_TPU_FORCE_MESH=1) runs with neither jax nor
    any kmer_tpu module loaded."""
    r = _python(
        "import os\n"
        "from kmer_tpu_torch.pipeline import yak\n"
        "from kmer_tpu_torch.tools import get_tool\n"
        "made = []\n"
        "real = yak.make_yak_engine\n"
        "from kmer_tpu_torch.tools import yak_count\n"
        "yak_count.make_yak_engine = lambda **kw: made.append(real(**kw)) "
        "or made[-1]\n"
        "for mesh in ('0', '1'):\n"
        "    os.environ['KMER_TPU_FORCE_MESH'] = mesh\n"
        f"    assert get_tool('yak-count')(['-b20', {READS!r}, "
        f"{GENOME!r}]) == 0\n"
        "assert [type(e).__name__ for e in made] == ['YakEngine', "
        "'MeshYakEngine'], made\n",
        {"KMER_TPU_PLATFORM": "cpu", "KMER_TPU_TABLE_YAK": "1"})
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 2 * 1023
    assert r.stderr.count("distinct k-mers after shrinking") == 2


def test_host_tools_and_packed_ingest_never_import_jax(tmp_path):
    """kc-py1, kc-cpp1, kc-cpp2, vcf-vaf-counter and bam-vaf-counter (on
    an unindexed BAM: the native scan where it builds), and kc-c4 under
    KMER_TPU_PACKED=1, run with neither jax nor any kmer_tpu module
    loaded."""
    d = str(tmp_path)
    pat = os.path.join(d, "p.pat")
    with open(pat, "w") as f:
        f.write("chr1\t100\t101\trs1\tA\tC\tACGTACGTACGTACGTACGTA\t"
                "ACGTACGTACCTACGTACGTA\n")
    bam = os.path.join(d, "noidx.bam")
    with open(os.path.join(FIXTURES, "sampleA_aln.bam"), "rb") as f, \
            open(bam, "wb") as g:
        g.write(f.read())
    r = _python(
        "import gzip, io\n"
        "from kmer_tpu_torch.tools import get_tool\n"
        "from kmer_tpu_torch.pipeline import counter\n"
        f"assert counter._use_packed_ingest([{READS!r}]) == "
        "counter.native_reader()\n"
        f"assert get_tool('kc-c4')(['-k31', {READS!r}]) == 0\n"
        f"raw = gzip.open({GENOME!r}).read()\n"
        "sys.stdin = io.TextIOWrapper(io.BytesIO(raw))\n"
        "assert get_tool('kc-py1')([]) == 0\n"
        f"open({d!r} + '/g.fa', 'wb').write(raw)\n"
        "for t in ('kc-cpp1', 'kc-cpp2'):\n"
        f"    assert get_tool(t)(['-k21', {d!r} + '/g.fa']) == 0\n"
        f"pat = {pat!r}\n"
        f"assert get_tool('vcf-vaf-counter')(['-p', pat, '-v', "
        f"{os.path.join(FIXTURES, 'sampleA.bcf')!r}, '-o', "
        f"{d!r} + '/v.vaf']) == 0\n"
        f"assert get_tool('bam-vaf-counter')(['-p', pat, '-o', "
        f"{d!r} + '/b.vaf', {bam!r}]) == 0\n",
        {"KMER_TPU_PLATFORM": "cpu", "KMER_TPU_PACKED": "1"})
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 4 * 255
    for name in ("v.vaf", "b.vaf"):
        with open(os.path.join(d, name)) as f:
            assert f.readline().startswith("# Average depth:")


def test_mesh_never_imports_jax():
    """kc-c4 and yak-count (one file and two) on the mesh
    (KMER_TPU_FORCE_MESH=1, four CPU shards) run with neither jax nor any
    kmer_tpu module loaded."""
    r = _python(
        "import torch\n"
        "from kmer_tpu_torch.dist import sharded\n"
        "sharded.default_devices = lambda: [torch.device('cpu')] * 4\n"
        "from kmer_tpu_torch.pipeline import counter\n"
        "assert isinstance(counter.make_count_engine(31),\n"
        "                  counter.MeshSortCountEngine)\n"
        "from kmer_tpu_torch.tools import get_tool\n"
        f"assert get_tool('kc-c4')(['-k31', {READS!r}]) == 0\n"
        f"assert get_tool('yak-count')(['-b20', {READS!r}]) == 0\n"
        f"assert get_tool('yak-count')(['-b20', {READS!r}, {GENOME!r}]) "
        "== 0\n",
        {"KMER_TPU_PLATFORM": "cpu", "KMER_TPU_FORCE_MESH": "1"})
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 255 + 2 * 1023
    assert r.stderr.count("[M] processed") > 2


def test_reused_host_modules_never_import_jax():
    """Every module of the port imports, and kc-c4 and yak-count run
    through the pure-Python reader copy (KMER_TPU_NO_NATIVE), with
    neither jax nor any kmer_tpu module loaded."""
    r = _python(
        "import importlib, pkgutil, kmer_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    kmer_tpu_torch.__path__, 'kmer_tpu_torch.')]\n"
        "assert 'kmer_tpu_torch.io.native' in mods, mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from kmer_tpu_torch.pipeline.counter import native_reader\n"
        "assert not native_reader()\n"
        "from kmer_tpu_torch.tools import get_tool\n"
        f"assert get_tool('kc-c4')(['-k31', {READS!r}]) == 0\n"
        f"assert get_tool('yak-count')(['-k21', '-b19', {READS!r}]) == 0\n",
        {"KMER_TPU_PLATFORM": "cpu", "KMER_TPU_NO_NATIVE": "1"})
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 255 + 1023


def test_launcher_runs_a_tool():
    env = dict(os.environ, KMER_TPU_PLATFORM="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "ktc_torch"), "kc-c1", "-k15",
         GENOME], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 255
    r = subprocess.run([sys.executable, os.path.join(REPO, "ktc_torch")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and "kc-c4" in r.stderr
