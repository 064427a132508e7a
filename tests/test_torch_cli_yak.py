"""Single-file yak-count of the port (kmer_tpu_torch.tools) against
kmer_tpu.tools: stdout and its ordered `[M` stderr lines on the reads
fixture, at the engine's default stream chunk and tap budget and with a
small chunk and budget that make the ladders merge and the tap trip; the
usage and error text; KMER_TPU_FAST_YAK; two files.  Apart from
tests/test_torch_cli.py so that the two files can run on two workers."""

import pytest

from tests.test_torch_cli import GENOME, READS


# -- yak-count (single file) ------------------------------------------

YAK_ARGS = [["-k31"], ["-k31", "-b22"], ["-k21", "-b20", "-H3"],
            ["-k21", "-b19", "-K30000"], ["-k21", "-K25000"],
            ["-k15", "-b20"]]
_yak_want = {}


def _yak(pkg, args, capsys):
    """(rc, stdout, the ordered `[M` stderr lines) of one yak-count run."""
    import importlib

    rc = importlib.import_module(f"{pkg}.tools").get_tool("yak-count")(args)
    cap = capsys.readouterr()
    return rc, cap.out, [ln for ln in cap.err.splitlines()
                         if ln.startswith("[M")]


def _yak_jax(args, capsys):
    key = tuple(args)
    if key not in _yak_want:
        _yak_want[key] = _yak("kmer_tpu", [*args, READS], capsys)
    return _yak_want[key]


@pytest.mark.parametrize("mode", ["default", "stream_trips"])
@pytest.mark.parametrize("args", YAK_ARGS, ids=" ".join)
def test_yak_count_matches_jax(args, mode, capsys, monkeypatch):
    """stdout (1023 rows) and the `[M` lines equal the JAX package's.
    stream_trips: a small stream chunk and a small tap budget, so the
    (key, index) ladder merges runs and the tap compacts on budget trips
    (through the plain merge versions on the CPU)."""
    from kmer_tpu_torch.pipeline import yak
    from kmer_tpu_torch.table import compactor

    want = _yak_jax(args, capsys)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    trips = []
    if mode == "stream_trips":
        monkeypatch.setenv("KMER_TPU_TAP_BUDGET", str(1 << 20))
        monkeypatch.setattr(compactor, "_STREAM_CHUNK", 1 << 15)
        real = yak.YakSimTap.finish_batches

        def finish(self):
            real(self)
            trips.append(self.budget_trips)

        monkeypatch.setattr(yak.YakSimTap, "finish_batches", finish)
    got = _yak("kmer_tpu_torch", [*args, READS], capsys)
    assert want[0] == 0 and len(want[1].splitlines()) == 1023
    assert want[2][-1].startswith("[M::main]")
    assert got == want
    if mode == "stream_trips":
        assert trips and trips[0] > 0
    if args == ["-k21", "-b19", "-K30000"]:
        assert sum(ln.startswith("[M] ") for ln in got[2]) == 20
    if args == ["-k15", "-b20"]:
        assert "23242 distinct k-mers in the hash" in got[2][0]
        assert got[2][-1] == "[M::main] 23236 distinct k-mers after shrinking"


@pytest.mark.parametrize("args", [[], ["-k0", READS], ["-k33", READS],
                                  ["-p5", READS], ["/nonexistent.fa"]])
def test_yak_count_errors_match_jax(args, capsys, monkeypatch):
    """Usage and error text (stderr) and exit codes are identical."""
    from kmer_tpu.tools import get_tool as jax_tool
    from kmer_tpu_torch.tools import get_tool

    rc_want = jax_tool("yak-count")(args)
    want = capsys.readouterr()
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    rc = get_tool("yak-count")(args)
    got = capsys.readouterr()
    assert rc_want == 1
    assert (rc, got.out, got.err) == (rc_want, want.out, want.err)


def test_yak_count_fast_matches_jax(capsys, monkeypatch):
    """KMER_TPU_FAST_YAK=1 skips the simulation: one summary line."""
    monkeypatch.setenv("KMER_TPU_FAST_YAK", "1")
    want = _yak("kmer_tpu", ["-k21", "-b20", READS], capsys)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _yak("kmer_tpu_torch", ["-k21", "-b20", READS], capsys)
    assert got == want
    assert len(got[2]) == 2 and got[2][0].startswith("[M] processed 3000 ")


def test_yak_count_two_files_run(capsys, monkeypatch):
    """Two different files run the two-pass engine: exit 0, stdout and
    `[M` lines equal the JAX package's; the same file twice is
    single-file mode."""
    want = _yak("kmer_tpu", ["-k21", "-b20", READS, GENOME], capsys)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _yak("kmer_tpu_torch", ["-k21", "-b20", READS, GENOME], capsys)
    assert got[0] == 0 and len(got[1].splitlines()) == 1023
    assert got == want
    # the same file twice is single-file mode
    assert got != _yak("kmer_tpu_torch", ["-k21", "-b20", READS, READS],
                       capsys)
    assert _yak("kmer_tpu_torch", ["-k21", READS, READS], capsys)[0] == 0
