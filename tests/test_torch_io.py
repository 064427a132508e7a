"""The port's copies of the FASTA/FASTQ readers (kmer_tpu_torch.io)
against the JAX package's (kmer_tpu.io) on the fixtures and on a dirty
FASTQ: the native C++ reader and the pure-Python reader plus packing
must yield the same buffers, byte for byte, with the same per-buffer
totals, for every quality policy the tools use."""

import gzip
import os

import numpy as np
import pytest

from kmer_tpu.io import fastx as jfastx, native as jnative, packing as jpacking
from kmer_tpu_torch.io import fastx, native, packing

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
INPUTS = ["reads_small.fq.gz", "genome_small.fa.gz", "sampleA1.fq.gz",
          "sampleB.fq.gz", "dirty"]
POLICIES = {"stop": None, "kc-c3": ("resume", 0, 2),
            "kc-c4": ("resume", 21, 3)}

# a FASTQ with the cases the readers' state machine handles: CRLF, a
# multi-line record, N and lowercase bases, a quality-length mismatch, a
# read shorter than k, and a record after junk lines
_DIRTY = (
    b"@r1 desc\r\nACGTACGTACGTACGTACGTACGTAC\r\n+\r\nIIIIIIIIIIIIIIIIIIIIIIIIII\r\n"
    b"@r2\nACGTNNacgtACGTACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n"
    b"@r3\nACGTACGTACGTACGTACGTACGTACGT\n+\nIIII\n"
    b"@r4\nACGT\n+\nIIII\n"
    b"junk line\n"
    b">r5\nACGTACGTACGTAC\nGTACGTACGTACGTACGTAC\n"
    b"@r6\nTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT\n+\n"
    b"IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n"
) * 50


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    dirty = d / "dirty.fq.gz"
    with gzip.open(dirty, "wb") as f:
        f.write(_DIRTY)
    return {name: (str(dirty) if name == "dirty"
                   else os.path.join(FIXTURES, name)) for name in INPUTS}


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", INPUTS)
def test_native_reader_copy_matches_jax(paths, name, policy):
    if not (native.available() and jnative.available()):
        pytest.skip("the native reader does not build here (g++ or zlib)")
    k, qp = 21, POLICIES[policy]
    args = ([paths[name]], k, 3000, 4096, qp)
    _same(native.iter_packed_native(*args), jnative.iter_packed_native(*args))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", INPUTS)
def test_python_reader_copy_matches_jax(paths, name, policy):
    k, qp = 21, POLICIES[policy]
    blocks = list(fastx.read_blocks([paths[name]], k, 3000, qual_policy=qp))
    want = list(jfastx.read_blocks([paths[name]], k, 3000, qual_policy=qp))
    assert [(b.seqs, b.sum_len, b.n_kmers) for b in blocks] == \
        [(b.seqs, b.sum_len, b.n_kmers) for b in want]
    for b, w in zip(blocks, want):
        _same(packing.pack_block(b, 1 << 16), jpacking.pack_block(w, 1 << 16))


@pytest.mark.parametrize("no_native", [False, True])
def test_engine_reader_matches_jax(paths, no_native, monkeypatch):
    """The engine's whole reader stage (`_iter_packed`, native or pure
    Python) against the JAX counter's, buffer for buffer."""
    from kmer_tpu.pipeline import counter as jc
    from kmer_tpu_torch.pipeline import counter as tc

    if no_native:
        monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    for name in ("reads_small.fq.gz", "dirty"):
        args = ([paths[name]], 31, 5000, 5000 + 4096, ("resume", 31, 3))
        _same(tc._iter_packed(*args), jc._iter_packed(*args))


def test_native_library_builds_outside_the_sources():
    if not native.available():
        pytest.skip("the native reader does not build here (g++ or zlib)")
    from kmer_tpu_torch.kernels._build import BUILD_DIR

    so = native._library_path()
    assert os.path.dirname(so) == BUILD_DIR and os.path.exists(so)
    assert not any(f.endswith(".so") for f in
                   os.listdir(os.path.dirname(native.__file__)))
