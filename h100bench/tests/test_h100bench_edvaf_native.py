"""`edvaf_native_share` (metrics/edvaf_native_share.py) against a store
of the port's ed-vaf-counter spans built by hand, as
test_h100bench_edvaf.py builds them, and on the cell run small on the
CPU."""

import pytest

from h100bench.tests.helpers import run_small
from h100bench.tests.test_h100bench_edvaf import CELL, _job_spans, _read


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")


def _with_native(spans, native_bases):
    spans[1].attrs["native_bases"] = native_bases
    return spans


def test_native_share_reads_the_traced_jobs(monkeypatch):
    """An earlier run's job, all through FastxReader, before the traced
    one, whose 0.5 Gbases came 0.4 through the native reader: 80%; two
    traced jobs: 40%."""
    from h100bench.tests.test_h100bench_edvaf import _run

    store = _with_native(_job_spans(0.0), 0) + \
        _with_native(_job_spans(100.0), 400_000_000)
    assert _read(monkeypatch, "edvaf_native_share", store) == \
        pytest.approx(80.0)
    assert _read(monkeypatch, "edvaf_native_share", store, _run(2)) == \
        pytest.approx(40.0)
    whole = _with_native(_job_spans(0.0), 500_000_000)
    assert _read(monkeypatch, "edvaf_native_share", whole) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("store", [
    [], _job_spans(0.0), _with_native(_job_spans(0.0, bases=7), 7),
    _with_native(_job_spans(0.0, write=False), 500_000_000)])
def test_native_share_without_the_count_reads_none(monkeypatch, store):
    """No spans, a port whose `edvaf.file` has no `native_bases` (as
    before the count), a file whose bases are not the job's, a job cut
    short."""
    assert _read(monkeypatch, "edvaf_native_share", store) is None


def test_native_share_of_the_small_cell_is_100():
    """The cell on the CPU: every base through the native reader."""
    from kmer_tpu_torch.io import native

    if not native.available():
        pytest.skip("the native reader does not build here (g++ or zlib)")
    res = run_small(CELL, trace=True)
    assert res["correct"]
    assert res["metrics"]["edvaf_native_share"]["value"] == \
        pytest.approx(100.0)
