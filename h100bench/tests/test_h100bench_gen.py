"""The generators: the same seed gives the same inputs, byte for byte."""

import gzip
import hashlib

import numpy as np
import pytest

from h100bench import gen
from h100bench.tests.helpers import small_cell

SEEDS = [0, 2**31 + 11, 2**33 + 5]


def _digest(inputs):
    h = hashlib.sha256()
    for f in inputs.files:
        h.update(open(f.path, "rb").read())
        h.update(f.reads.tobytes())
    for key in ("fasta", "bed"):
        if key in inputs.extra:
            h.update(open(inputs.extra[key], "rb").read())
    return h.hexdigest()


@pytest.mark.parametrize("cell", ["mabs_kc_c4", "ngscm_vaf"])
@pytest.mark.parametrize("seed", SEEDS)
def test_inputs_repeat_per_seed(tmp_path, cell, seed):
    c = small_cell(cell)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = gen.make_inputs(c.config, seed, str(tmp_path / "a"), 9_000)
    b = gen.make_inputs(c.config, seed, str(tmp_path / "b"), 9_000)
    assert _digest(a) == _digest(b)
    (tmp_path / "c").mkdir()
    other = gen.make_inputs(c.config, seed + 1, str(tmp_path / "c"),
                            9_000)
    assert _digest(other) != _digest(a)


def test_reads_file_holds_the_codes(tmp_path):
    c = small_cell("mabs_kc_c4")
    inputs = gen.make_inputs(c.config, 5, str(tmp_path), 9_000)
    f = inputs.files[0]
    text = gzip.decompress(open(f.path, "rb").read())
    lines = text.split(b"\n")
    seqs = lines[1::2][:f.reads.shape[0]]
    assert len(seqs) == f.reads.shape[0] == 4_000
    assert all(s == gen.ACGTN[r].tobytes() for s, r in
               zip(seqs[:50], f.reads[:50]))
    assert text.count(b">") == 4_000 and f.bases == 400_000


def test_gzip_is_one_member_of_many_blocks(tmp_path, monkeypatch):
    monkeypatch.setattr(gen, "_GZ_BLOCK", 1000)
    text = bytes(np.random.default_rng(1).integers(65, 70, 25_000,
                                                   dtype=np.uint8))
    path = str(tmp_path / "x.gz")
    assert gen.write_gzip(path, [lambda: text[:7000],
                                 lambda: text[7000:]]) == 25_000
    raw = open(path, "rb").read()
    assert gzip.decompress(raw) == text
    assert raw.count(b"\x1f\x8b\x08") == 1  # one header: one member


def test_reads_rates_and_strands():
    rng = gen.rng_for(3, 1)
    genome = gen.genome_codes((3, 1), 100_000, 0.64)
    gc = np.isin(genome.numpy(), [1, 2]).mean()
    assert abs(gc - 0.64) < 0.01
    reads = gen.sample_reads(gen.device_rng("cpu", 3, 2), genome, 20_000,
                             100, 0.005, 0.0001, 0.5).numpy()
    assert reads.shape == (20_000, 100) and reads.max() <= 4
    assert 50 < (reads == 4).sum() < 400


def test_empty_gzip(tmp_path):
    path = str(tmp_path / "e.gz")
    assert gen.write_gzip(path, []) == 0
    assert gzip.decompress(open(path, "rb").read()) == b""


@pytest.mark.parametrize("n", [1, 59, 60, 61, 125])
def test_fasta_record_lines(n):
    seq = np.arange(n, dtype=np.uint8) % 4
    text = gen.fasta_record("c1", seq, 60)
    lines = text.decode().splitlines()
    assert lines[0] == ">c1" and text.endswith(b"\n")
    assert "".join(lines[1:]) == "".join("ACGT"[c] for c in seq)
    assert all(len(x) == 60 for x in lines[1:-1]) and 1 <= len(lines[-1]) <= 60
