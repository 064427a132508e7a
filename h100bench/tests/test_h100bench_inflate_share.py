"""`inflate_native_share` (metrics/inflate_native_share.py) against
stores of the port's `reader.block` spans built by hand, as
test_h100bench_port_spans.py builds them: 100 where the decoder served
every byte, less where other bytes were served, None on a port whose
spans do not count `inflate_bytes`."""

import pytest

from h100bench.spec import load_module
from h100bench.tests.test_h100bench_port_spans import OUTSIDE, _run, _span


def _blocks(lo, inflated, served):
    """One traced job's block calls, starting at lo: (inflated, served)
    text bytes a call."""
    return [_span("reader.block", lo + 1.0 + i, lo + 1.5 + i, thread=1,
                  inflate_ns=10**8, native_ns=2 * 10**8,
                  inflate_bytes=a, text_bytes=b)
            for i, (a, b) in enumerate(zip(inflated, served))]


def _share(monkeypatch, store, traced=True):
    from kmer_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(store))
    return load_module("metrics", "inflate_native_share").read(_run(traced))


# the spans outside the traced jobs, counting other bytes than the
# decoder's: they would pull the share down if they were read
_OUTSIDE = [_span(s.name, s.t0, s.t1, thread=s.thread,
                  **dict(s.attrs, inflate_bytes=0, text_bytes=10**9))
            for s in OUTSIDE if s.name == "reader.block"]


def test_every_byte_from_the_decoder_reads_100(monkeypatch):
    store = _OUTSIDE + _blocks(10.0, [300, 500, 0], [300, 500, 0]) + \
        _blocks(30.0, [700], [700])
    assert _share(monkeypatch, store) == pytest.approx(100.0)


def test_bytes_served_otherwise_lower_the_share(monkeypatch):
    """A job whose second file was plain text (or served past the
    decoder): 600 of 1,000 bytes from the decoder."""
    store = _blocks(10.0, [300, 0], [300, 400]) + \
        _blocks(30.0, [300], [300])
    assert _share(monkeypatch, store) == pytest.approx(60.0)


@pytest.mark.parametrize("store, traced", [
    ([], True),  # nothing recorded
    (_OUTSIDE, True),  # nothing inside the traced jobs
    (_blocks(10.0, [5], [5]), False),  # no traced stretch
    (_blocks(10.0, [0], [0]), True),  # no text served
])
def test_nothing_to_read_reads_none(monkeypatch, store, traced):
    assert _share(monkeypatch, store, traced) is None


def test_a_port_without_the_count_reads_none(monkeypatch):
    """The parent's spans: `inflate_ns` and `native_ns` alone."""
    store = [_span("reader.block", 11.0, 12.0, thread=1, inflate_ns=10**8,
                   native_ns=2 * 10**8)]
    assert _share(monkeypatch, store) is None
